"""The collectives the port's parallel paths use, over `torch.distributed`.

  * `all_reduce_sum(t, group)`: autograd-aware — its backward all-reduces
    the incoming gradient, so a loss on one rank reaches the inputs of
    every rank (global-batch BatchNorm, `models/layers.py`);
  * `all_reduce_mean_(tensors, group)`: averages a list of tensors in place
    through one flat bucket per (device, dtype) — one call per optimizer
    group's gradients, not one per leaf;
  * `broadcast_(tensors, src, group)`: the same bucketing for a broadcast;
  * `all_gather(t, group)`: every rank's `t`, in rank order.

Every collective runs on the tensors' own device. The NCCL backend takes
CUDA tensors only, so a CPU tensor (an Adam step count, a checkpoint's
bytes) travels through the rank's card there; gloo takes both.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def world_size(group=None) -> int:
    """The ranks of `group` (the default group for None); 1 without a
    process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def comm_device(t: torch.Tensor, group=None) -> torch.device:
    """Where `t` travels: its own device, except a CPU tensor on NCCL,
    which goes through the rank's current card."""
    if t.device.type == "cpu" and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of `group` of `t`, differentiable: the backward is
    the all-reduce of the gradient."""
    return _AllReduceSum.apply(t, group)


def _buckets(tensors: Sequence[torch.Tensor], group
             ) -> Dict[Tuple[torch.device, torch.dtype], List[int]]:
    out: Dict[Tuple[torch.device, torch.dtype], List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault((comm_device(t, group), t.dtype), []).append(i)
    return out


def _bucketed(tensors: Sequence[torch.Tensor], group, op) -> None:
    """Run `op(flat)` on one flat copy of each (device, dtype) bucket of
    `tensors`, then copy the result back into them."""
    for (dev, _), idx in _buckets(tensors, group).items():
        flat = torch.cat([tensors[i].detach().reshape(-1).to(dev)
                          for i in idx])
        op(flat)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].detach().copy_(flat[off:off + n].view_as(tensors[i]))
            off += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Average `tensors` over the ranks of `group`, in place."""
    w = world_size(group)

    def op(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(w)
    _bucketed(tensors, group, op)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               group=None) -> None:
    """Overwrite `tensors` with rank `src`'s, in place."""
    _bucketed(tensors, group,
              lambda flat: dist.broadcast(flat, src=src, group=group))


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """[rank 0's t, rank 1's t, …]; every rank's t has t's shape."""
    dev = comm_device(t, group)
    t = t.contiguous().to(dev)
    parts = [torch.empty_like(t) for _ in range(world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def broadcast_object(obj, src: int = 0, group=None):
    """Rank `src`'s picklable `obj` on every rank."""
    box: List[Optional[object]] = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
