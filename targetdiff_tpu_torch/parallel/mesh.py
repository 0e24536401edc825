"""Data parallelism over torch.distributed, counterpart of
targetdiff_tpu/parallel/mesh.py (data parallel only; its tensor-parallel
`param_shardings` is not ported).

Every process ("rank") holds the same global batch, built from the same
loader seed, and computes on its own row slice of it; parameters and
optimizer state are replicated. Random draws are taken at the global shape
from a generator seeded alike on every rank and sliced, so a run over W
ranks draws what one process draws (JAX gets the same from drawing a
global array and sharding it).

The collectives are the ones the gloo and NCCL backends both take on CUDA
and CPU tensors: `all_reduce` and `broadcast`. Rows are gathered as an
all-reduce of a zero-filled global buffer in which each rank writes its
own rows. A failed init or collective raises: a run never goes on with
fewer ranks or on one process.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group: its rank, the number of
    ranks and the device it computes on (the counterpart of make_mesh's
    "dp" axis)."""

    rank: int
    world: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def default_backend(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ones. Two ranks on one card need
    gloo: NCCL refuses two ranks on one GPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(kind: str, rank: int) -> torch.device:
    """The device of a rank: the CPU, `cuda:0` for every rank on a machine
    with one card, else `cuda:{rank % cards}` (one card a rank when the
    machine has a card for each of its ranks)."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda': torch.cuda.is_available() is False")
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


def init_distributed(coordinator: Optional[str], num_processes: Optional[int],
                     process_id: Optional[int], backend: str, device,
                     timeout_s: float = 600.0) -> bool:
    """Start the process group (counterpart of JAX `init_distributed`).
    `coordinator` is `host:port` (TCP) or a `file://` path every rank can
    reach. Returns False, and starts nothing, when there is one process;
    True once every rank has joined. `timeout_s` bounds each collective."""
    if coordinator is None and num_processes is None:
        return False
    if num_processes is None or num_processes < 1:
        raise ValueError(f"--dist_num_processes must be given and positive, got {num_processes}")
    if num_processes == 1:
        return False
    if coordinator is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address and the process id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        torch.cuda.set_device(device)
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))
    return True


def current_mesh(device) -> Mesh:
    """The Mesh of the started process group on `device`."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    return Mesh(rank=dist.get_rank(), world=dist.get_world_size(), device=torch.device(device))


def row_range(n: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's rows [start, stop) of n global rows: equal slices when W
    divides n, else slices that differ by at most one row (a rank may get
    none when n < W)."""
    return n * mesh.rank // mesh.world, n * (mesh.rank + 1) // mesh.world


def shard_rows(batch, mesh: Mesh, even: bool = True):
    """This rank's row slice of a global ComplexBatch (or of any NamedTuple
    of tensors with the batch first), the counterpart of `shard_batch`.
    even=True refuses a batch that the ranks cannot split equally."""
    n = batch[0].shape[0]
    if even and n % mesh.world:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.world} ranks")
    start, stop = row_range(n, mesh)
    return type(batch)(*[t[start:stop] for t in batch])


def _to_device(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t if t.device == mesh.device else t.to(mesh.device)


def replicate_state(module: torch.nn.Module, optimizer, mesh: Mesh) -> None:
    """Broadcast the parameters, buffers and optimizer state of rank 0 to
    every rank, in place (counterpart of `replicate_state`). Every rank
    must hold the same structure: the same model and optimizer, resumed
    from the same checkpoint or from none."""
    tensors = list(module.parameters()) + list(module.buffers())
    for state in optimizer.optimizer.state.values():
        tensors += [v for _, v in sorted(state.items()) if torch.is_tensor(v)]
    with torch.no_grad():
        for t in tensors:
            buf = _to_device(t.detach(), mesh)
            dist.broadcast(buf, src=0)
            if buf is not t:
                t.copy_(buf)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], mesh: Mesh) -> int:
    """Replace every gradient by its mean over the ranks: one flat buffer a
    step, summed and divided by W. With equal row shards and a loss that is
    a mean over rows, that is the gradient of the global batch. Returns the
    buffer's bytes."""
    params = [p for p in params if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= mesh.world
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n
    return flat.numel() * flat.element_size()


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of x over the ranks (a new tensor on x's device)."""
    buf = _to_device(x.detach().clone(), mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(x.device)


def gather_rows(x: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """The n global rows of which this rank holds `row_range(n, mesh)` in x,
    on every rank (counterpart of JAX `_fetch_global`): each rank writes
    its rows into a zero buffer and the buffers are summed."""
    start, stop = row_range(n, mesh)
    if x.shape[0] != stop - start:
        raise ValueError(f"rank {mesh.rank} holds {x.shape[0]} rows, its share of {n} is "
                         f"{stop - start}")
    dtype = torch.int32 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((n,) + tuple(x.shape[1:]), dtype=dtype, device=mesh.device)
    buf[start:stop] = x.detach().to(device=mesh.device, dtype=dtype)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(device=x.device, dtype=x.dtype)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank. With NCCL, on this rank's card."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


def _rank_entry(rank: int, fn: Callable, world: int, device: str, backend: Optional[str],
                args: tuple, workdir: str, timeout_s: float, threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(device, rank)
    init_distributed(f"file://{os.path.join(workdir, 'rendezvous')}", world, rank,
                     backend or default_backend(dev), dev, timeout_s)
    try:
        out = fn(Mesh(rank=rank, world=world, device=dev), *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, device: str = "cuda", backend: Optional[str] = None,
              args: tuple = (), timeout_s: float = 600.0,
              threads: Optional[int] = None) -> List:
    """Run fn(mesh, *args) on `world` new processes (spawned), each a rank of
    one process group on `rank_device(device, rank)`, and return the ranks'
    results (torch.save-able), rank 0 first. `fn` must be importable by its
    module path. If a rank raises or dies, the others are stopped and this
    raises; past `timeout_s` (which also bounds each collective) every rank
    is stopped and TimeoutError raised. `threads` sets each rank's CPU
    threads."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_entry, nprocs=world, join=False, start_method="spawn",
                                 args=(fn, world, device, backend, args, tmp, timeout_s, threads))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
