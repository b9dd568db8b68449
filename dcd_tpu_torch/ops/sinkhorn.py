"""Entropy-regularised optimal transport (Sinkhorn) as a declarative layer.

The counterpart of ``dcd_tpu/ops/sinkhorn.py`` (reference
``GMW/lib/optimal_transport.py:26-232``):

* forward: the scaling ``u <- r / K(c / K^T u)`` with
  ``K = exp(-lambda * min(M, 5))``, stopped as the JAX package's
  ``lax.while_loop`` stops it: when every sample of the batch has
  ``|u - u_prev| <= tolerance`` (a NaN never does), or after
  ``max_iterations``;
* backward: the implicit gradient of Deep Declarative Networks Lemma 4.4
  (:75-128) through one Cholesky of the Schur complement of the KKT system
  per sample (``cholesky_ex``, which never raises: a factorisation that
  fails gives NaN, as ``jax.scipy.linalg.cho_factor`` does) or matrix-free
  conjugate gradients.

fp32 throughout. The two switches of the JAX module are read at import,
with its defaults: ``DCD_SINKHORN_SOLVER`` (``chol`` | ``cg``) and
``DCD_SINKHORN_K_DTYPE`` (``float32`` | ``bfloat16``: K stored in bf16,
multiplied with fp32 accumulation and output).

Profiler spans: ``sinkhorn.scaling`` (the forward), ``sinkhorn.vjp`` (the
backward), and inside it ``sinkhorn.schur_product`` and
``sinkhorn.cholesky``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch
from torch.profiler import record_function

SOLVER = os.environ.get("DCD_SINKHORN_SOLVER", "chol")
_CG_TOL = 1e-8
_CG_MAX_ITERS = 256
K_DTYPE = os.environ.get("DCD_SINKHORN_K_DTYPE", "float32")
# iterations between two host reads of a loop's stop flag: each read waits
# for the device, and iterations past the stop are frozen, not counted
CHECK_EVERY = 8

State = Tuple[torch.Tensor, ...]


def while_loop(cond: Callable[[State], torch.Tensor], body: Callable[[State], State],
               state: State, max_iterations: int) -> Tuple[State, torch.Tensor]:
    """The result of ``jax.lax.while_loop(cond, body, state)`` capped at
    ``max_iterations`` bodies, and the number of bodies that counted (a
    device tensor). ``cond`` is evaluated on the device before each body;
    once it is false the state stays as it was, so the host reads the flag
    only every CHECK_EVERY iterations and the result does not depend on
    when it reads it."""
    active = torch.ones((), dtype=torch.bool, device=state[0].device)
    count = torch.zeros((), dtype=torch.int64, device=state[0].device)
    for i in range(max_iterations):
        active = active & cond(state)
        state = tuple(torch.where(active, new, old) for new, old in zip(body(state), state))
        count = count + active
        if (i + 1) % CHECK_EVERY == 0 and not bool(active):
            break
    return state, count


def _kmat(K: torch.Tensor, vec: torch.Tensor, transpose: bool) -> torch.Tensor:
    """K (or Kᵀ) times ``vec`` in K's storage type, accumulated and
    returned in fp32 (``preferred_element_type=float32``)."""
    A = K.transpose(1, 2) if transpose else K
    if K.dtype == torch.float32:
        return torch.bmm(A, vec)
    vec = vec.to(K.dtype)
    if K.is_cuda:
        return torch.bmm(A, vec, out_dtype=torch.float32)
    return torch.bmm(A.float(), vec.float())  # bf16 products are exact in fp32


def sinkhorn_scaling(M: torch.Tensor, r: Optional[torch.Tensor] = None,
                     c: Optional[torch.Tensor] = None, lmbda: float = 10.0,
                     tolerance: float = 1e-9, max_iterations: int = 100,
                     max_distance: float = 5.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, iterations): the transport matrix for cost M (b, m, n) with
    marginals r (b, m) and c (b, n) (uniform when None), and the number of
    scaling iterations run."""
    with record_function("sinkhorn.scaling"):
        b, m, n = M.shape
        K = torch.exp(-lmbda * torch.clamp(M, max=max_distance))
        if K_DTYPE == "bfloat16":
            K = K.to(torch.bfloat16)
        if r is None:
            r = torch.full((b, m), 1.0 / m, dtype=M.dtype, device=M.device)
        if c is None:
            c = torch.full((b, n), 1.0 / n, dtype=M.dtype, device=M.device)
        r, c = r[..., None], c[..., None]

        def cond(state):
            u, u_prev = state
            return ~torch.all(torch.abs(u - u_prev) <= tolerance)

        def body(state):
            u, _ = state
            return r / _kmat(K, c / _kmat(K, u, True), False), u

        (u, _), iterations = while_loop(cond, body, (r, torch.ones_like(r)), max_iterations)
        v = c / _kmat(K, u, True)
        return (u * K.to(M.dtype)) * v.transpose(1, 2), iterations


def sinkhorn_forward(M: torch.Tensor, r: Optional[torch.Tensor] = None,
                     c: Optional[torch.Tensor] = None, lmbda: float = 10.0,
                     tolerance: float = 1e-9, max_iterations: int = 100,
                     max_distance: float = 5.0) -> torch.Tensor:
    """Transport matrix P for cost M (b, m, n); r (b, m), c (b, n) marginals."""
    return sinkhorn_scaling(M, r, c, lmbda, tolerance, max_iterations, max_distance)[0]


def _bmv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(b, k, n) @ (b, n) -> (b, k)."""
    return torch.bmm(A, x[..., None])[..., 0]


def _schur_solve_cg(B1, d1inv, d2, rhs):
    """Solve S x = rhs for S = D2 - B1ᵀ D1⁻¹ B1 (SPD) without forming S:
    Jacobi-preconditioned conjugate gradients, batched, until every
    sample's relative residual is under _CG_TOL or after _CG_MAX_ITERS."""
    B1t = B1.transpose(1, 2)
    diagS = d2 - _bmv((B1 * B1).transpose(1, 2), d1inv)
    pinv = 1.0 / torch.clamp(diagS, min=1e-30)

    def matvec(x):
        return d2 * x - _bmv(B1t, d1inv * _bmv(B1, x))

    z0 = pinv * rhs
    rhs_nrm = torch.clamp((rhs * rhs).sum(-1), min=1e-30)

    def cond(state):
        _, r, _, _ = state
        return ~torch.all((r * r).sum(-1) <= (_CG_TOL ** 2) * rhs_nrm)

    def body(state):
        x, r, p, rz = state
        Ap = matvec(p)
        alpha = rz / torch.clamp((p * Ap).sum(-1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = pinv * r
        rz_new = (r * z).sum(-1)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        return x, r, z + beta[:, None] * p, rz_new

    (x, _, _, _), _ = while_loop(cond, body, (torch.zeros_like(rhs), rhs, z0, (rhs * z0).sum(-1)),
                                 _CG_MAX_ITERS)
    return x


def _cholesky(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a batch, NaN for each sample whose
    factorisation failed (as ``jax.lax.linalg.cholesky`` gives), with no
    host synchronisation and no exception."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info != 0)[:, None, None], torch.full_like(L[:1], float("nan")), L)


def _sinkhorn_vjp_dense(P: torch.Tensor, lmbda: float, v: torch.Tensor) -> torch.Tensor:
    """Implicit gradient dJ/dM (b, m*n) from dJ/dP (b, m*n) at the transport
    P (b, m, n): one Cholesky of the Schur complement S per sample and a
    block substitution, as the JAX package's ``_sinkhorn_vjp_dense``."""
    with record_function("sinkhorn.vjp"):
        b, m, n = P.shape
        B = lmbda * P
        hinv = B.reshape(b, -1)  # vec of the H⁻¹ diagonal
        d1inv = 1.0 / B.sum(-1)[:, 1:]  # (b, m-1)
        d2 = B.sum(-2)  # (b, n)
        B1 = B[:, 1:, :]  # (b, m-1, n)

        vHinv = v * hinv
        blocks = vHinv.reshape(b, m, n)
        u1 = blocks.sum(-1)[:, 1:]
        u2 = blocks.sum(-2)

        # [[D1, B1], [B1ᵀ, D2]] [x1; x2] = [u1; u2] through the Schur complement
        # S = D2 - B1ᵀ D1⁻¹ B1: x2 = S⁻¹ (u2 - B1ᵀ D1⁻¹ u1), x1 = D1⁻¹ (u1 - B1 x2)
        t = u2 - _bmv(B1.transpose(1, 2), d1inv * u1)
        if SOLVER == "cg":
            x2 = _schur_solve_cg(B1, d1inv, d2, t)
        else:
            with record_function("sinkhorn.schur_product"):
                S = torch.bmm((B1 * d1inv[:, :, None]).transpose(1, 2), B1).neg_()
                S.diagonal(dim1=-2, dim2=-1).add_(d2)
            with record_function("sinkhorn.cholesky"):
                x2 = torch.cholesky_solve(t[..., None], _cholesky(S))[..., 0]
            del S
        x1 = d1inv * (u1 - _bmv(B1, x2))

        # row 0 of the (m, n) grid is x2 alone; rows 1..m-1 are x1_i + x2_j
        u5 = x1[:, :, None] + x2[:, None, :]
        uHinv = torch.cat([x2[:, None, :], u5], dim=-2).reshape(b, -1) * hinv
        return uHinv - vHinv


class RegularisedTransport(torch.autograd.Function):
    """The differentiable Sinkhorn layer (reference RegularisedTransport
    :224-232): returns (P, iterations); gradients flow to M only."""

    @staticmethod
    def forward(ctx, M, r, c, lmbda=10.0, tolerance=1e-9, max_iterations=100):
        P, iterations = sinkhorn_scaling(M, r, c, lmbda, tolerance, max_iterations)
        ctx.save_for_backward(P)
        ctx.lmbda = lmbda
        ctx.mark_non_differentiable(iterations)
        return P, iterations

    @staticmethod
    def backward(ctx, g, _):
        (P,) = ctx.saved_tensors
        b, m, n = P.shape
        grad = _sinkhorn_vjp_dense(P, ctx.lmbda, g.reshape(b, -1)).reshape(b, m, n)
        return grad, None, None, None, None, None


def regularised_transport(M, r, c, lmbda: float = 10.0, tolerance: float = 1e-9,
                          max_iterations: int = 100) -> torch.Tensor:
    """P of :class:`RegularisedTransport` (r and c are constants)."""
    return RegularisedTransport.apply(M, r, c, lmbda, tolerance, max_iterations)[0]


def sinkhorn_objective(M, P, r, c, lmbda: float = 10.0) -> torch.Tensor:
    """Entropy-regularised objective (reference objectiveFn :39-49): P* must
    minimise it subject to the marginals."""
    rc = torch.einsum("bi,bj->bij", r, c)
    logprc = torch.where(rc == 0.0, torch.zeros_like(rc),
                         torch.log(torch.clamp(P, min=1e-36)) - torch.log(torch.clamp(rc, min=1e-36)))
    return (P * M).sum((-2, -1)) + (P * logprc / lmbda).sum((-2, -1))
