"""Process groups, meshes and the sharded paths of the port (counterpart of
`dvg_tpu/parallel/mesh.py`).

One process per rank, joined by `torch.distributed`:

  * **training** — data parallel over the default group: each rank steps
    on its rows of the global batch, BatchNorm's statistics are global
    (`models/layers.py::batch_norm_train` under a group), the gradients of
    each optimizer group are averaged in one flat all-reduce, and every
    rank ends the step with the same weights (`train/step.py`);
  * **generation** — a ("sample", "data") mesh: the S futures split over
    "sample", the eval batch's rows over "data". Each rank rolls out its
    block with nothing sent during the loop, then the (S_local, n_free,
    B_local) metrics are all-gathered into (S, n_free, B) on every rank
    (`shard_diverse_metrics`).

`distributed_init` reads `dvg_tpu`'s env contract (DVG_COORDINATOR=host:port,
DVG_NUM_PROCESSES, DVG_PROCESS_ID) or torchrun's (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT). A rank's card is cuda:LOCAL_RANK (LOCAL_RANK
from the environment, else the rank: the DVG_* contract then means one
host). The backend is chosen, never guessed around: NCCL on the card, gloo
on the CPU, and gloo on the card only when asked for. NCCL refuses two
ranks on one card, so asking for it with more ranks on a host
(LOCAL_WORLD_SIZE, else the world size) than cards raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dvg_tpu_torch.config import resolve_device
from dvg_tpu_torch.parallel.collectives import (all_gather, broadcast_,
                                                broadcast_object, world_size)

BACKENDS = ("nccl", "gloo")
METRICS = ("ssim", "psnr", "mse")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def distributed_init(device="cuda", backend: str = None,
                     timeout_s: float = 1800.0) -> bool:
    """Join the process group the environment describes, on `device`'s
    type with `backend` (None: nccl for cuda, gloo for cpu). Idempotent;
    without either env contract a no-op that returns False."""
    if dist.is_initialized():
        return True
    env = os.environ
    if env.get("DVG_COORDINATOR"):
        init = f"tcp://{env['DVG_COORDINATOR']}"
        world, rank = int(env["DVG_NUM_PROCESSES"]), int(env["DVG_PROCESS_ID"])
    elif "RANK" in env and "WORLD_SIZE" in env:
        init = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    elif env.get("DVG_MULTIHOST") == "1":
        raise ValueError(
            "DVG_MULTIHOST=1 discovers a Cloud TPU slice, which the port has "
            "no use for: launch with torchrun, or set DVG_COORDINATOR, "
            "DVG_NUM_PROCESSES and DVG_PROCESS_ID")
    else:
        return False
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if dev_type != "cuda":
            raise ValueError("the nccl backend needs device cuda; use gloo "
                             "on the CPU")
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"backend nccl runs one rank per card, but this host has "
                f"{local_world} ranks and {cards} card(s) (NCCL refuses two "
                "ranks on one device); pass --dist_backend gloo "
                "(backend='gloo') to share a card")
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(_local_card(rank))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _local_card(rank: int) -> int:
    return _env_int("LOCAL_RANK", rank) % torch.cuda.device_count()


def rank_device(device="cuda") -> torch.device:
    """The device this rank runs on: `device`, with the rank's own card
    (cuda:LOCAL_RANK) for a bare "cuda" under a process group."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None or not dist.is_initialized():
        return dev
    return torch.device("cuda", _local_card(dist.get_rank()))


def is_coordinator() -> bool:
    """True on the rank that owns the shared writes (checkpoints,
    metrics.jsonl, npz, PNG and GIF): rank 0, or any run without a process
    group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def mesh_layout(axis_sizes: Sequence[Tuple[str, int]], world: int
                ) -> Tuple[List[str], List[int]]:
    """(names, sizes) of a mesh over `world` ranks from (name, size) pairs;
    one size may be -1 and absorbs the rest. Default: [("data", world)].
    Raises where ranks would be missing or sit idle."""
    if not axis_sizes:
        axis_sizes = [("data", world)]
    names = [n for n, _ in axis_sizes]
    sizes = [int(s) for _, s in axis_sizes]
    pairs = list(zip(names, sizes))
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh {pairs}: at most one axis size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if world % known:
            raise ValueError(
                f"mesh {pairs}: -1 cannot absorb the rest — {world} ranks do "
                f"not divide by the fixed axes' product {known} (ranks would "
                "sit idle)")
        sizes[sizes.index(-1)] = world // known
    total = int(np.prod(sizes))
    if total > world:
        raise ValueError(f"mesh {pairs} needs {total} ranks, have {world}")
    if total < world:
        raise ValueError(f"mesh {pairs} holds {total} of {world} ranks; the "
                         "other ranks would sit idle")
    return names, sizes


def make_mesh(axis_sizes: Sequence[Tuple[str, int]] = None):
    """A `DeviceMesh` over every rank of the process group, ranks placed in
    process-major (row-major) order, as `dvg_tpu`'s make_mesh lays out
    jax.devices(): [("sample", S), ("data", D)] puts rank s·D + d at (s,
    d)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "distributed_init() first")
    from torch.distributed.device_mesh import init_device_mesh
    names, sizes = mesh_layout(axis_sizes, dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def broadcast_state(obj, src: int = 0, group=None):
    """Rank `src`'s state on every rank, in place; returns `obj`. `obj` is
    a TrainState (weights, BN statistics, every Adam moment, the update
    counts and the step) or a tensor, or a dict, list or tuple of them.
    Without a process group of more than one rank, a no-op."""
    if world_size(group) == 1:
        return obj
    if hasattr(obj, "model") and hasattr(obj, "opts"):
        obj.step, counts = broadcast_object(
            (obj.step, dict(obj.opts.counts)), src, group)
        obj.opts.counts.update(counts)
        tensors = (list(obj.model.state_dict().values())
                   + obj.opts.state_tensors())
    else:
        tensors = _leaves(obj)
    broadcast_(tensors, src, group)
    return obj


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    raise TypeError(f"broadcast_state: cannot broadcast a {type(tree)}")


def shard_diverse_metrics(fns, mesh, full_cov: bool = False) -> Callable:
    """The sharded diverse eval: `fns` are the rollout functions built for
    this rank's S_local = S / mesh["sample"] futures. The returned
    metrics(x, seed=0, noise=None, device="cuda") takes the whole batch x
    (T, B, H, W, C) and, optionally, the whole eps (n_free, S, B, g_dim),
    runs this rank's (sample, data) block — futures sample_offset +
    [0, S_local) of rows row_offset + [0, B_local) — and returns
    {"ssim", "psnr", "mse"}, each (S, n_free, B), gathered on every rank.
    The blocks draw the eps the one-process run draws for the same global
    ids, so the result is the one-process result.

    Pass `full_cov=cfg.full_cov_sampling`: the batch-correlated GP draw is
    defined over the WHOLE eval batch, so sharding its rows over "data"
    would correlate only within each shard; the guard sits here, at the
    mechanism that creates the hazard, so every caller is covered."""
    sizes = mesh_sizes(mesh)
    unknown = set(sizes) - {"sample", "data"}
    if unknown:
        raise ValueError(f"mesh axes must be 'sample' and/or 'data', got "
                         f"{mesh.mesh_dim_names}")
    n_d = sizes.get("data", 1)
    if full_cov and n_d > 1:
        raise ValueError(
            "full_cov_sampling correlates the GP draw across the WHOLE eval "
            "batch; sharding batch rows over 'data' would silently "
            "correlate only within each shard — use a pure sample-parallel "
            "mesh or disable full_cov")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    i_s, i_d = coord.get("sample", 0), coord.get("data", 0)
    s_l = fns.nsample
    # rank of every (sample, data) block, sample-major
    grid = mesh.mesh.reshape(sizes.get("sample", 1), n_d).tolist()

    def metrics(x, seed: int = 0, noise=None, device="cuda"
                ) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(x)
        b = x.shape[1]
        if b % n_d:
            raise ValueError(f"batch {b} does not divide over {n_d} data "
                             "shards")
        b_l = b // n_d
        rows = slice(i_d * b_l, (i_d + 1) * b_l)
        if noise is not None:
            noise = torch.as_tensor(noise)[:, i_s * s_l:(i_s + 1) * s_l, rows]
        out = fns.diverse_metrics(x[:, rows], seed=seed, noise=noise,
                                  device=device, row_offset=i_d * b_l,
                                  sample_offset=i_s * s_l)
        parts = all_gather(torch.stack([out[k] for k in METRICS]))
        full = torch.cat([torch.cat([parts[r] for r in row], dim=3)
                          for row in grid], dim=1).to(out["ssim"].device)
        return dict(zip(METRICS, full))

    return metrics
