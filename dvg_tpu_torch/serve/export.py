"""Ahead-of-time export of the serving paths as `torch.export` programs
(counterpart of `dvg_tpu/serve/export.py`).

Serving wants each rollout as a self-contained artifact: no model Python
on the serving host, no retracing, a fixed interface. `export_serving`
prepares a checkpoint's weights once (BN folded, cast to the compute dtype,
channels_last, the GP caches built: `RolloutFns.prepare`), wraps them in a
module around the entry's traceable core (`RolloutFns.cores`), traces it
at fixed shapes with `torch.export.export` and writes the program, weights
embedded, with `torch.export.save` (a `.pt2`), beside a `.json` sidecar of
its geometry. `load_serving` restores a callable from the file alone; it
imports the op registration of the metric kernels (`ops/ssim_cuda.py`) and
of the conv epilogue (`ops/epilogue.py`), and nothing of `models/` or
`generate/`.

Exported entry points (shapes fixed at export time; `seed` is a 0-dim
int64 tensor input, so one artifact serves every seed):
  posterior        (x (T, B, H, W, C) f32)   -> frames (T, B, H, W, C) f32
  diverse_metrics  (x, seed)                 -> {ssim, psnr, mse: (S, T', B)}
  gp_trigger       (x, seed)                 -> (frames, diagnostics)
Each returns what the live entry of `make_rollout_fns` returns for the
same seed. The loop is unrolled: a diverse_metrics program of a
`use_pallas` checkpoint holds K1 as one `dvg_tpu_torch::ssim_cyclic` node
per free-run step, which launches the hand-written kernel on the card.

With `mesh_samples=N` (diverse_metrics only; `mesh_data=M` as well for a
("sample", N) × ("data", M) mesh) the artifact is ONE rank's program: S/N
futures over B/M rows, with the block's global `sample_offset` and
`row_offset` as two more 0-dim int64 inputs. `load_serving` runs it on
every rank of a process group of N·M ranks, each on its own block, and
all-gathers the blocks as `parallel.shard_diverse_metrics` does. The
port's GP noise is a function of the global sample and row ids, so the
gathered metrics are the one-process artifact's for the same seed: unlike
`dvg_tpu`'s sharded artifact, which folds its key by device, no key
translation is needed.

The program is the stock ATen graph that torch.export traces, run by
`torch.export.load(...).module()`; it is not compiled further (no
AOTInductor), as `dvg_tpu`'s StableHLO is compiled by its loading runtime.

CLI:  python -m dvg_tpu_torch.serve.export <model_dir> <out.pt2> \\
          [--entry posterior] [--nsample 100] [--batch 50] [--n_eval 105] \\
          [--dtype bfloat16] [--device cuda] [--mesh_samples N] \\
          [--mesh_data M]
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Callable

import torch
from torch import nn

ENTRIES = ("posterior", "diverse_metrics", "gp_trigger")


class _Program(nn.Module):
    """A prepared model and its GP caches as one module around a core, so
    that torch.export lifts the weights and caches into the program."""

    def __init__(self, core: Callable, prepared):
        super().__init__()
        self.core = core
        self.model = prepared.model.requires_grad_(False)
        self.cache_type, self.prepared_type = type(prepared.cache), \
            type(prepared)
        self.n_cache = len(prepared.cache)
        # in f32 the two caches are the same tensors: lift them once. Each
        # is copied: some alias the GP's parameters, which the program
        # holds too
        self.shared = all(a is b for a, b in zip(prepared.cache,
                                                 prepared.cache32))
        for i, t in enumerate(prepared.cache):
            self.register_buffer(f"cache_{i}", t.clone())
        if not self.shared:
            for i, t in enumerate(prepared.cache32):
                self.register_buffer(f"cache32_{i}", t.clone())

    def forward(self, x: torch.Tensor, *ids: torch.Tensor):
        cache = self.cache_type(*(getattr(self, f"cache_{i}")
                                  for i in range(self.n_cache)))
        cache32 = cache if self.shared else self.cache_type(
            *(getattr(self, f"cache32_{i}") for i in range(self.n_cache)))
        return self.core(self.prepared_type(self.model, cache, cache32), x,
                         *ids)


def export_serving(model_dir: str, out_path: str, entry: str = "posterior",
                   nsample: int = None, batch_size: int = None,
                   n_eval: int = None, dtype: str = None, device="cuda",
                   mesh_samples: int = 0, mesh_data: int = 0) -> str:
    """Export one serving entry point of a checkpoint to `out_path` (+ a
    .json sidecar with the geometry). Returns out_path.

    `model_dir` is anything `checkpoint.load_model` reads: a run directory
    or a `model.ckpt` written by either package or by
    `train/import_torch`. Its config takes the eval protocol's override
    (n_eval 105, batch 50), then the arguments given. `device` is where the
    program runs: "cuda" (the default; raises without a card) or "cpu".
    `mesh_samples` and `mesh_data` make the per-rank artifact of a sharded
    diverse_metrics (module docstring)."""
    from dvg_tpu_torch.checkpoint import load_model
    from dvg_tpu_torch.config import resolve_device
    from dvg_tpu_torch.generate.rollout import make_rollout_fns

    if entry not in ENTRIES:
        raise ValueError(f"unknown entry {entry!r}; one of {ENTRIES}")
    if (mesh_samples or mesh_data) and entry != "diverse_metrics":
        raise ValueError(
            "mesh_samples/mesh_data apply to the diverse_metrics entry")
    if mesh_data and not mesh_samples:
        raise ValueError("mesh_data requires mesh_samples (use "
                         "mesh_samples=1 for a pure data-sharded export)")
    dev = resolve_device(device)
    saved_cfg, model = load_model(model_dir, device=dev, synced=False)
    cfg = saved_cfg.generation_override()
    if nsample:
        cfg = cfg.replace(nsample=nsample)
    if batch_size:
        cfg = cfg.replace(batch_size=batch_size)
    if n_eval:
        cfg = cfg.replace(n_eval=n_eval, n_future=n_eval - cfg.n_past)
    if dtype:
        cfg = cfg.replace(dtype=dtype)

    n_s, n_d = mesh_samples or 1, mesh_data or 1
    if mesh_samples:
        if cfg.nsample % n_s:
            raise ValueError(
                f"nsample {cfg.nsample} not divisible by {n_s}")
        if cfg.batch_size % n_d:
            raise ValueError(
                f"batch {cfg.batch_size} not divisible by {n_d}")
        if cfg.full_cov_sampling and n_d > 1:
            raise ValueError(
                "full_cov_sampling correlates the GP draw across the WHOLE "
                "eval batch; sharding batch rows over 'data' would "
                "correlate only within each shard — export a pure "
                "sample-sharded artifact or disable full_cov")
    fns = make_rollout_fns(model, cfg.replace(nsample=cfg.nsample // n_s))
    x = torch.zeros((cfg.n_eval, cfg.batch_size // n_d, cfg.image_width,
                     cfg.image_width, cfg.channels), device=dev)
    # the program's int64 scalar inputs after x: the seed, then a sharded
    # block's sample and row offsets
    n_ids = {"posterior": 0, "gp_trigger": 1,
             "diverse_metrics": 3 if mesh_samples else 1}[entry]
    core = getattr(fns.cores, entry)
    if mesh_samples:
        def core(p, x, seed, sample_offset, row_offset,
                 _core=fns.cores.diverse_metrics):
            return _core(p, x, seed, row_offset, sample_offset)
    args = (x,) + tuple(torch.zeros((), dtype=torch.int64)
                        for _ in range(n_ids))
    with torch.no_grad():
        program = _Program(core, fns.prepare())
        exported = torch.export.export(program, args)
    # the writer would store the example inputs beside the program: the
    # zero clip alone is 258 MB at the protocol's (105, 50, 64, 64, 3)
    exported.example_inputs = None
    with warnings.catch_warnings():
        # the writer calls every non-contiguous weight (channels_last convs,
        # the transposed GP cache) incomplete; it writes each whole with
        # its strides all the same
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(exported, out_path)
    # the sidecar last and whole (written aside, then renamed): where it
    # exists, the artifact beside it is complete
    with open(out_path + ".json.tmp", "w") as f:
        json.dump({"entry": entry, "config": cfg.to_dict(),
                   "platforms": [dev.type],
                   "in_shapes": [list(a.shape) for a in args],
                   "mesh_samples": mesh_samples or None,
                   "mesh_data": mesh_data or None,
                   "nr_devices": n_s * n_d,
                   "bytes": os.path.getsize(out_path),
                   # beyond dvg_tpu's keys: the graph's size, which sets
                   # the export's and the load's seconds
                   "nodes": len(exported.graph.nodes)}, f, indent=1)
    os.replace(out_path + ".json.tmp", out_path + ".json")
    return out_path


def load_serving(path: str) -> Callable:
    """File → callable `served(x)` (posterior) or `served(x, seed)`. The
    program runs on the device it was exported for, under inference_mode
    as the live entries run (no grad, and less bookkeeping per op than
    no_grad); inputs go there first (x as f32, seed as an int64 scalar on
    the CPU). A CUDA artifact raises where there is no card; it never runs
    elsewhere.

    A sharded artifact (`mesh_samples`) needs an initialized process group
    of mesh_samples·mesh_data ranks; every rank calls `served(x, seed)` with
    the whole batch and gets the whole (S, T', B) metrics back."""
    # registers K1, K2 and K3
    from dvg_tpu_torch.ops import epilogue, ssim_cuda  # noqa: F401

    with open(path + ".json") as f:
        side = json.load(f)
    platform = side["platforms"][0]
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{path} is a CUDA artifact, but torch.cuda is not available; "
            "it runs on the card it was exported for, or nowhere")
    mesh_samples = side["mesh_samples"]
    if mesh_samples:
        _require_group(side)
    exported = torch.export.load(path)
    if mesh_samples:
        from dvg_tpu_torch.parallel import rank_device
        dev = rank_device(platform)
        exported = _on(exported, dev)
    else:
        dev = _device(exported)
    program = exported.module()

    def as_x(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def ids(*v) -> tuple:
        return tuple(torch.as_tensor(i, dtype=torch.int64) for i in v)

    if side["entry"] == "posterior":
        def served(x):
            with torch.inference_mode():
                return program(as_x(x))
        return served
    if not mesh_samples:
        def served(x, seed=0):
            with torch.inference_mode():
                return program(as_x(x), *ids(seed))
        return served
    return _sharded(program, side, dev, as_x, ids)


def _device(exported) -> torch.device:
    """The device of an exported program's weights."""
    return next(iter(exported.state_dict.values())).device


def _on(exported, dev: torch.device):
    """A program exported on one card, moved to this rank's card (cuda:k
    on a host with one rank per card). Never to another device type."""
    have = _device(exported)
    if have.type != dev.type:
        raise RuntimeError(f"the artifact is on {have}, the rank on {dev}")
    if have == dev:
        return exported
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(exported, dev)


def _require_group(side) -> None:
    """A sharded artifact's process group: initialized, of
    mesh_samples·mesh_data ranks, or raise naming the number."""
    import torch.distributed as dist

    n_s, n_d = side["mesh_samples"], side["mesh_data"] or 1
    need = n_s * n_d
    if not dist.is_initialized() or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"a ('sample', {n_s}) x ('data', {n_d}) artifact runs on a "
            f"process group of {need} ranks (have {have or 'none'}): "
            "launch with torchrun or the DVG_* env and call "
            "parallel.distributed_init() first")


def _sharded(program, side, dev, as_x, ids) -> Callable:
    """The per-rank program of a sharded artifact behind
    `parallel.shard_diverse_metrics`: this rank's block of the
    ("sample", N) × ("data", M) mesh with its global offsets, the blocks
    all-gathered onto every rank."""
    from dvg_tpu_torch.parallel import make_mesh, shard_diverse_metrics

    n_s, n_d = side["mesh_samples"], side["mesh_data"] or 1
    axes = [("sample", n_s)] + ([("data", n_d)] if side["mesh_data"] else [])

    class Block:
        """This rank's (samples × rows) block of the one-process grid."""
        nsample = side["config"]["nsample"] // n_s

        @staticmethod
        def diverse_metrics(x, seed=0, noise=None, device=None,
                            row_offset=0, sample_offset=0):
            with torch.inference_mode():
                return program(as_x(x), *ids(seed, sample_offset,
                                             row_offset))

    metrics = shard_diverse_metrics(
        Block, make_mesh(axes),
        full_cov=side["config"]["full_cov_sampling"])

    def served(x, seed=0):
        return metrics(x, seed=seed)
    return served


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Export a serving entry point of a DVG checkpoint as a "
                    "torch.export program (.pt2)")
    ap.add_argument("model_dir")
    ap.add_argument("out")
    ap.add_argument("--entry", default="posterior", choices=ENTRIES)
    ap.add_argument("--nsample", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--n_eval", type=int, default=0)
    ap.add_argument("--dtype", default="")
    ap.add_argument("--device", default="cuda",
                    help="where the program runs: cuda (default) or cpu")
    ap.add_argument("--mesh_samples", type=int, default=0,
                    help="export one rank's program of the N-rank "
                         "sample-sharded rollout (diverse_metrics only)")
    ap.add_argument("--mesh_data", type=int, default=0,
                    help="additionally shard batch rows over M ranks: a "
                         "('sample', N) x ('data', M) serving mesh")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = export_serving(
        a.model_dir, a.out, entry=a.entry, nsample=a.nsample or None,
        batch_size=a.batch or None, n_eval=a.n_eval or None,
        dtype=a.dtype or None, device=a.device,
        mesh_samples=a.mesh_samples, mesh_data=a.mesh_data)
    with open(out + ".json") as f:
        nodes = json.load(f)["nodes"]
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB, {nodes} graph "
          f"nodes) in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
