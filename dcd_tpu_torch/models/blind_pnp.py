"""Declarative weighted blind PnP (a bi-level pose solver).

The counterpart of ``dcd_tpu/models/blind_pnp.py`` (reference
``GMW/lib/nonlinear_weighted_blind_pnp.py``, imported by the reference's
model but not called on its shipped path). The inner problem minimises the
transport-weighted angular reprojection objective over a 6-dof pose
theta = (angle_axis, t),

    J(P, theta) = sum_mn P_mn (1 - <bearing(p2d_m), normalize(R p3d_n + t)>),

by a fixed number of damped Newton steps; the gradient with respect to P
comes from the implicit function theorem, dtheta/dP = -H⁻¹ B, with H the
inner Hessian over theta and B the mixed second derivative, both from
``torch.func``.
"""

from __future__ import annotations

import torch
from torch.func import grad, hessian, vjp

from ..ops.geometry3d import (angle_axis_to_rotation_matrix, points_to_bearings,
                              transform_and_normalise_points)


def objective(P: torch.Tensor, theta: torch.Tensor, p2d: torch.Tensor, p3d: torch.Tensor) -> torch.Tensor:
    """Weighted angular reprojection (a scalar per batch element)."""
    R = angle_axis_to_rotation_matrix(theta[..., :3])
    dot = torch.einsum("...md,...nd->...mn", points_to_bearings(p2d),
                       transform_and_normalise_points(p3d, R, theta[..., 3:]))
    return ((1.0 - dot) * P).sum(dim=(-2, -1))


def _solve_inner(P, theta0, p2d, p3d, iters: int = 50, damping: float = 1e-4):
    """Damped Newton, a fixed number of iterations: a step that is not
    finite falls back to 0.1 g, and one that does not lower the objective
    to a gradient step of 0.05."""
    def obj(theta):
        return objective(P, theta, p2d, p3d)

    grad_fn, hess_fn = grad(obj), hessian(obj)
    eye = torch.eye(6, dtype=theta0.dtype, device=theta0.device)
    theta = theta0
    for _ in range(iters):
        g = grad_fn(theta)
        step = torch.linalg.solve_ex(hess_fn(theta) + damping * eye, g)[0]
        step = torch.where(torch.isfinite(step).all(), step, 0.1 * g)
        new = theta - step
        theta = torch.where(obj(new) < obj(theta), new, theta - 0.05 * g)
    return theta


class WeightedBlindPnP(torch.autograd.Function):
    """argmin_theta J(P, theta); the gradient flows to P implicitly (the
    other inputs get zeros, as in the JAX package)."""

    @staticmethod
    def forward(ctx, P, theta0, p2d, p3d, iters=50):
        with torch.no_grad():
            theta = _solve_inner(P, theta0, p2d, p3d, iters)
        ctx.save_for_backward(P, theta, theta0, p2d, p3d)
        return theta

    @staticmethod
    def backward(ctx, g):
        P, theta, theta0, p2d, p3d = ctx.saved_tensors
        with torch.enable_grad():
            H = hessian(lambda th: objective(P, th, p2d, p3d))(theta)
            H = H + 1e-6 * torch.eye(6, dtype=theta.dtype, device=theta.device)
            v = torch.linalg.solve_ex(H, g)[0]
            _, vjp_P = vjp(lambda P_: grad(lambda th: objective(P_, th, p2d, p3d))(theta), P)
            (gP,) = vjp_P(-v)
        return gP, torch.zeros_like(theta0), torch.zeros_like(p2d), torch.zeros_like(p3d), None


def weighted_blind_pnp(P, theta0, p2d, p3d, iters: int = 50) -> torch.Tensor:
    """The pose of P (m, n) transport weights, theta0 (6,) initial pose,
    p2d (m, 2) normalised image points and p3d (n, 3) points."""
    return WeightedBlindPnP.apply(P, theta0, p2d, p3d, iters)
