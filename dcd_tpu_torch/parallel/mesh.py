"""Data parallelism over processes: the rendezvous, the batch split, the
weights' broadcast and the collectives the training step needs.

The twin of ``dcd_tpu/parallel/mesh.py``, in PyTorch's idiom: one process
per card, ``torch.distributed`` with NCCL between cards and gloo on the CPU
(or where the caller asks for it), ``DistributedDataParallel`` for the
gradient all-reduce (``engine/train.py``), and a BatchNorm whose batch
moments are summed over the group (``models/layers.py``). The JAX package
shards one program's global batch over a ``data`` mesh axis; here each
process holds its slice of the global batch (:func:`shard_batch`), and the
loss's denominators and BN's moments are reduced over the group so that the
step is the one-process step on the global batch.

A rendezvous is ``host:port`` (a TCP store that rank 0 serves) or
``file://PATH`` (a file store, for processes on one machine). Nothing falls
back: a failed NCCL init raises, and ranks that would share a card under
NCCL raise before NCCL starts, naming the card.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

# a collective waits this long for the other ranks (rank 0 alone runs
# --generate_for_GMW while the others wait at a barrier)
TIMEOUT = datetime.timedelta(minutes=30)


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _store(coordinator: str, num_processes: int, process_id: int,
           timeout: datetime.timedelta) -> dist.Store:
    if coordinator.startswith("file://"):
        store = dist.FileStore(coordinator[len("file://"):], num_processes)
        store.set_timeout(timeout)
        return store
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is neither host:port nor file://PATH")
    return dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                         timeout=timeout)


def _claim_card(store: dist.Store, process_id: int, num_processes: int,
                device: torch.device, timeout: datetime.timedelta = TIMEOUT) -> None:
    """Raise when another rank of the group uses the same card (NCCL needs
    one card per rank)."""
    props = torch.cuda.get_device_properties(device)
    card = f"{socket.gethostname()}:{getattr(props, 'uuid', device.index)}"
    store.set(f"card/{process_id}", card)
    keys = [f"card/{r}" for r in range(num_processes)]
    store.wait(keys, timeout)
    owners = [store.get(k).decode() for k in keys]
    shared = [r for r, c in enumerate(owners) if c == card]
    if len(shared) > 1:
        raise RuntimeError(f"ranks {shared} would share card {device} ({props.name}, {card}) "
                           "under NCCL; NCCL needs one card per rank (ask for the gloo backend "
                           "to run several ranks on one card)")


def initialize_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, backend: Optional[str] = None,
                           device: Optional[torch.device] = None,
                           timeout: datetime.timedelta = TIMEOUT) -> Optional[dist.ProcessGroup]:
    """Join ``num_processes`` processes into the default process group
    through ``coordinator`` (``host:port``, served by rank 0, or
    ``file://PATH``) and return it. One process with no coordinator is a
    no-op that returns None, as in the JAX package.

    ``backend`` defaults to :func:`default_backend` of ``device`` (NCCL
    where ``device`` is a CUDA device, gloo otherwise). Under NCCL the rank
    uses ``device`` (``cuda:process_id % device_count`` when not given), the
    ranks must hold distinct cards, and the communicator is made now, so
    that a failing NCCL raises here. A collective that waits longer than
    ``timeout`` for the other ranks raises."""
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    if num_processes == 1 and coordinator is None:
        return None
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator (host:port)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    if device is None:
        device = (torch.device("cuda", process_id % torch.cuda.device_count())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    backend = backend or default_backend(device)
    store = _store(coordinator, num_processes, process_id, timeout)
    kwargs = {}
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the NCCL backend needs a CUDA device, not {device}")
        torch.cuda.set_device(device)
        _claim_card(store, process_id, num_processes, device, timeout)
        kwargs["device_id"] = device  # makes the communicator now
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes,
                            timeout=timeout, **kwargs)
    return dist.group.WORLD


def shutdown() -> None:
    """Leave the default process group, if any."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_index(group: Optional[dist.ProcessGroup] = None) -> int:
    return dist.get_rank(group) if dist.is_available() and dist.is_initialized() else 0


def process_count(group: Optional[dist.ProcessGroup] = None) -> int:
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def barrier(group: Optional[dist.ProcessGroup] = None) -> None:
    """Wait for every rank of the group (nothing without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group)


def shard_batch(batch: Mapping[str, Any], index: int, count: int,
                microbatches: int = 1) -> Dict[str, Any]:
    """Rank ``index``'s slice of a global batch of ``count`` ranks: arrays,
    tensors and lists along their first axis. With ``microbatches`` A > 1
    the global batch is A microbatches in order (as the JAX step reshapes
    it, ``dcd_tpu/engine/train.py``), and the rank gets its slice of each,
    so that its own A microbatches are the global ones' slices."""
    first = next(v for v in batch.values() if not isinstance(v, str))
    n = len(first)
    if n % (count * microbatches):
        raise ValueError(f"batch {n} does not split into {microbatches} microbatches "
                         f"over {count} ranks")
    per_mb = n // microbatches
    local = per_mb // count
    rows = np.concatenate([np.arange(m * per_mb + index * local, m * per_mb + (index + 1) * local)
                           for m in range(microbatches)])

    def take(v):
        if isinstance(v, list):
            return [v[i] for i in rows]
        if torch.is_tensor(v):
            return v[torch.as_tensor(rows, device=v.device)]
        return np.asarray(v)[rows]

    return {k: take(v) for k, v in batch.items()}


@torch.no_grad()
def replicate(model: torch.nn.Module, group: Optional[dist.ProcessGroup] = None) -> torch.nn.Module:
    """Broadcast ``model``'s parameters and buffers from the group's rank 0
    to every rank, in place, one collective per type; returns the model."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    src = dist.get_global_rank(group, 0) if group is not None else 0
    by_type: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in list(model.parameters()) + list(model.buffers()):
        by_type.setdefault(t.dtype, []).append(t.data)
    for tensors in by_type.values():
        flat = _flatten_dense_tensors(tensors)
        dist.broadcast(flat, src, group=group)
        for t, v in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
            t.copy_(v)
    return model


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, differentiable: each rank's output is the sum of
    every rank's input, so the gradient of a rank's input is the sum over
    the group of the output's gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        with record_function("parallel.all_reduce_sum"):
            grad = grad.clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                   differentiable: bool = False) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor); with ``differentiable``
    the sum carries gradients back to every rank's input."""
    with record_function("parallel.all_reduce_sum"):
        if differentiable:
            return _AllReduceSum.apply(x, group)
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank: int, fn: Callable, nprocs: int, coordinator: Optional[str], backend: str,
             outdir: str, timeout: datetime.timedelta) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(outdir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    if coordinator is not None:
        device = torch.device("cpu")
        if backend == "nccl":
            device = torch.device("cuda", rank % torch.cuda.device_count())
        initialize_distributed(coordinator, nprocs, rank, backend=backend, device=device,
                               timeout=timeout)
    try:
        result = fn(rank, nprocs, *args)
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        barrier()
    finally:
        shutdown()


def launch(fn: Callable, nprocs: int, args: Sequence = (), backend: str = "gloo",
           workdir: Optional[str] = None, join_group: bool = True,
           timeout: datetime.timedelta = TIMEOUT, start_method: str = "spawn") -> List[Any]:
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` spawned processes, each
    on one intra-op thread, and return each rank's result. Arguments and
    results go through files, pickled (numpy arrays travel fastest: torch's
    own format serialises them element by element). With ``join_group`` the
    processes first join one process group (``backend``, a file store under
    a temporary directory); without, ``fn`` makes its own rendezvous (as the
    command lines do). ``fn`` must be importable by the children: a
    module-level function of this package. If a process fails, the others
    are stopped and its traceback raised; a collective of the group that
    waits longer than ``timeout`` fails. ``start_method`` ``"forkserver"``
    forks the processes from multiprocessing's fork server, with the modules
    it preloaded already imported (``multiprocessing.set_forkserver_preload``)."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    outdir = tempfile.mkdtemp(dir=workdir)
    coordinator = f"file://{os.path.join(outdir, 'rendezvous')}" if join_group else None
    # the arguments go through a file: a spawned child reads the pipe from
    # its parent only after its imports, so large arguments in the pipe would
    # start the children one after the other
    with open(os.path.join(outdir, "args.pkl"), "wb") as f:
        pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
    try:
        mp.start_processes(_spawned, args=(fn, nprocs, coordinator, backend, outdir, timeout),
                           nprocs=nprocs, join=True, start_method=start_method)
        results = []
        for r in range(nprocs):
            with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
