"""Data parallelism across processes: the counterpart of the JAX mesh.

Counterpart of flashvtg_tpu/parallel/mesh.py and flashvtg_tpu/train/loop.py
(`build_mesh_for`, the multi-host rows). The JAX package runs one global
batch as SPMD over a "data" mesh: jax.sharding splits its rows over the
devices, and XLA computes the same function as one device would, the batch
couplings included. The port runs one process per card under a
torch.distributed process group (torchrun's idiom; NCCL on the card, gloo
on the CPU and for two ranks on one card), each rank holding `bsz / world`
rows of the global batch, and keeps the global-batch semantics exactly:

  * the global batch is the host-contiguous concatenation of the ranks'
    rows (rank 0's first), as the JAX mesh lays hosts out;
  * what couples the batch's rows reads the global batch: `roll_rows`, the
    negative pass's roll along axis 0 (a rank's last row takes the next
    rank's first); `gather_rows`, the global rows (the donor tables of the
    ACA mask, the criterion's inputs); both differentiable, the gradient
    going back to the rank that owns the row;
  * each rank backpropagates its share of the global loss and
    `all_reduce_grads_` SUMs the gradients, so every rank holds the
    gradient of the global loss (not DDP's mean of per-rank means).

The couplings act only inside `split_batch()`, which the train step opens
around its forward and criterion: outside it (one process, or an eval that
deals whole batches to ranks) `batch_world()` is 1, and `gather_rows` and
`roll_rows` are the identity and torch.roll. Every collective raises when
it fails; nothing falls back.
"""

from __future__ import annotations

import contextlib
import os
from datetime import timedelta
from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

_SPLIT = {"depth": 0}


def init_group(backend: Optional[str] = None, device=None) -> bool:
    """The default process group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); returns whether a
    group is active. Without WORLD_SIZE in the environment (no torchrun) it
    starts nothing. `backend` None takes NCCL for a CUDA `device` (the card
    LOCAL_RANK names becomes the current one) and gloo for the CPU."""
    if active():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        torch.cuda.set_device(local_rank())
    backend = backend or ("nccl" if cuda else "gloo")
    dist.init_process_group(backend, init_method="env://", timeout=timedelta(minutes=10))
    return True


def close_group() -> None:
    """Destroy the default process group, if one is active."""
    if active():
        dist.destroy_process_group()


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def backend() -> Optional[str]:
    return dist.get_backend() if active() else None


def build_group_for(bsz: int) -> int:
    """The rows each rank takes of a global batch of `bsz`: bsz / world.
    Raises, as the JAX loop does, when the world does not divide bsz."""
    w = world()
    if bsz % w:
        raise ValueError(f"bsz={bsz} must be divisible by the process group's world size {w}")
    return bsz // w


def shard_rows_for_host(rows, process_index: Optional[int] = None,
                        process_count: Optional[int] = None):
    """Partition dataset rows across processes: a deterministic strided
    split, so that every process sees a class-balanced stream (a copy of
    the JAX function; defaults: this rank and the world)."""
    pi = rank() if process_index is None else process_index
    pc = world() if process_count is None else process_count
    return rows[pi::pc]


def assembled_order(rows, world_size: int, local_bsz: int) -> np.ndarray:
    """The global batches' row order over a shuffled epoch: global batch i
    is the concatenation over ranks p of shard_rows_for_host(rows, p)[i *
    local_bsz : (i + 1) * local_bsz], the layout of the JAX mesh; a short
    tail is dropped. The identity for one process (with its tail)."""
    rows = np.asarray(rows)
    if world_size == 1:
        return rows
    shards = [shard_rows_for_host(rows, p, world_size) for p in range(world_size)]
    steps = min(len(s) for s in shards) // local_bsz
    return np.concatenate(
        [s[i * local_bsz:(i + 1) * local_bsz] for i in range(steps) for s in shards]
    ).astype(rows.dtype) if steps else rows[:0]


def replicate_params(model: torch.nn.Module) -> None:
    """Every parameter and buffer of `model` broadcast from rank 0, so that
    all ranks start from rank 0's weights."""
    if not active():
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)


@contextlib.contextmanager
def split_batch():
    """The scope in which the batch a rank holds is its rows of the global
    batch: `batch_world()` is the world size inside it, and the model's and
    the criterion's batch couplings read the global batch."""
    _SPLIT["depth"] += 1
    try:
        yield
    finally:
        _SPLIT["depth"] -= 1


def batch_world() -> int:
    """The ranks the current batch is split over: world() inside
    `split_batch()`, else 1."""
    return world() if _SPLIT["depth"] > 0 else 1


def batch_slice(n_local: int) -> slice:
    """This rank's rows of a global batch of batch_world() * n_local rows."""
    r = rank() if batch_world() > 1 else 0
    return slice(r * n_local, (r + 1) * n_local)


class _GatherRows(torch.autograd.Function):
    """all_gather along axis 0; the backward all-reduces (SUM) the gradient
    of the global rows and returns this rank's slice of it."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        ctx.n = x.shape[0]
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        r = dist.get_rank()
        return grad[r * ctx.n:(r + 1) * ctx.n]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of a batch-leading tensor, in rank order
    (rank 0's rows first); differentiable: the gradient of each row goes
    back to its rank. `x` itself where the batch is not split."""
    if batch_world() == 1:
        return x
    return _GatherRows.apply(x)


def roll_rows(x: torch.Tensor, shift: int = -1) -> torch.Tensor:
    """torch.roll(global batch, shift, 0), this rank's rows of it: with
    shift -1 a rank's last row is the next rank's first (the last rank's,
    rank 0's). Differentiable through `gather_rows` (the tensors rolled are
    the text tokens and phrase slots: small beside the step)."""
    if batch_world() == 1:
        return torch.roll(x, shift, dims=0)
    return torch.roll(gather_rows(x), shift, dims=0)[batch_slice(x.shape[0])]


def all_reduce_grads_(params: Iterable[torch.nn.Parameter]) -> None:
    """SUM every parameter's gradient over the group, in one flat buffer
    (each rank's gradient is that of its share of the global loss, so the
    sum is the global loss's gradient). Every parameter must hold a
    gradient. No-op without a group."""
    if not active():
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def all_gather_objects(obj) -> List:
    """Every rank's picklable `obj`, in rank order ([obj] without a group)."""
    if not active():
        return [obj]
    out: List = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj):
    """Rank 0's picklable `obj` on every rank (`obj` itself without a group)."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    if active():
        dist.barrier()
