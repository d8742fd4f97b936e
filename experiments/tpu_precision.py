"""Does the TPU's matmul precision explain the JAX soak's scores?

XLA on a TPU runs an f32 contraction (dot, einsum, tensordot) at its
DEFAULT precision: one pass with both operands rounded to bf16 and an f32
accumulator. In the bf16 recipe the convs and the LSTM already compute in
bf16 in both packages; the f32 islands (the GP's products, the BN
statistics' fold) run in f32 on the card but at bf16 operand precision on
the TPU. `tpu_dots()` makes the port do the same: every f32 `torch.einsum`,
`torch.bmm`, `torch.matmul`, `torch.mm` and `@` rounds its operands to bf16
(differentiably: the backward rounds each operand's gradient the same way)
and accumulates in f32. Cholesky factors and triangular solves stay exact.

    python experiments/tpu_precision.py soak --out RUN [soak flags]
        the soak driver (dvg_tpu_torch.cli.soak) with every CLI it runs
        under tpu_dots(); its manifest gains an "emulation" entry
    python experiments/tpu_precision.py cli MODULE [flags]
        one CLI module (dvg_tpu_torch.cli.train, ...) under tpu_dots()
    python experiments/tpu_precision.py score RUN [RUN ...]
        per run, the epoch plots' (model/sample_<e>.png) mean SSIM by
        frame and their ground-truth rows' distance from the port's test
        clips, and eval batch 0's mean SSIM by free step beside the
        blank-frame and copy-last-frame predictions of the same clips

`score` runs on the CPU; the others on the card unless given --device cpu.
"""

from __future__ import annotations

import glob
import json
import os
import runpy
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PLOT_N_EVAL, PLOT_SAMPLES, TILE = 15, 5, 64   # cli/train.py's _plot grid
SCORE_STEPS = (0, 1, 2, 5, 9, 10, 14, 20, 30, 50, 70, 99)


def tpu_dots() -> None:
    """Round the operands of every f32 contraction to bf16 from here on."""
    import torch

    def r(t):
        if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
            return t.to(torch.bfloat16).to(torch.float32)
        return t

    def wrap(f):
        return lambda a, b, *args, **kw: f(r(a), r(b), *args, **kw)

    einsum = torch.einsum
    torch.einsum = lambda eq, *ops: einsum(eq, *[r(o) for o in ops])
    for name in ("bmm", "matmul", "mm"):
        setattr(torch, name, wrap(getattr(torch, name)))
    torch.Tensor.__matmul__ = wrap(torch.Tensor.__matmul__)


def run_cli(module: str, argv: list) -> int:
    tpu_dots()
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        return int(e.code or 0)
    return 0


def run_soak(argv: list) -> int:
    from dvg_tpu_torch.cli import soak
    rc = soak.main(argv, launcher=[sys.executable, os.path.abspath(__file__),
                                   "cli"])
    out = soak.build_parser().parse_args(argv).out
    path = os.path.join(out, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["emulation"] = ("experiments/tpu_precision.py tpu_dots(): f32 "
                             "contractions at bf16 operand precision, as "
                             "XLA's DEFAULT on a TPU")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return rc


def _ssim(gt, pred) -> np.ndarray:
    """Per-image SSIM of (N, H, W) frames in [0, 1]."""
    import torch
    from dvg_tpu_torch.ops.ssim import ssim_psnr_images_plain
    g = torch.as_tensor(np.ascontiguousarray(gt[..., None]), dtype=torch.float32)
    p = torch.as_tensor(np.ascontiguousarray(pred[..., None]),
                        dtype=torch.float32)
    return ssim_psnr_images_plain(g, p)[0].numpy()


def plot_tiles(png: str) -> np.ndarray:
    """A training plot's grid (per clip the ground truth, then the best of
    5 samples by MSE and 4 random draws, n_eval frames each) → its tiles,
    (clips, 1 + samples, n_eval, 64, 64) in [0, 1]."""
    from PIL import Image
    im = np.asarray(Image.open(png).convert("L")).astype(np.float32) / 255
    step = TILE + 1
    rows = (im.shape[0] + 1) // step
    tiles = np.stack([np.stack([im[r * step:r * step + TILE,
                                   c * step:c * step + TILE]
                                for c in range(PLOT_N_EVAL)])
                      for r in range(rows)])          # (rows, T, 64, 64)
    per = PLOT_SAMPLES + 1
    return tiles[:rows // per * per].reshape(-1, per, PLOT_N_EVAL, TILE, TILE)


def plot_profile(tiles: np.ndarray) -> tuple:
    """`plot_tiles`' grid → mean SSIM by frame of the best rows and of the
    random rows, (n_eval,) each."""
    gt = np.broadcast_to(tiles[:, :1], tiles[:, 1:].shape)
    s = _ssim(gt.reshape(-1, TILE, TILE), tiles[:, 1:].reshape(-1, TILE, TILE))
    s = s.reshape(-1, PLOT_SAMPLES, PLOT_N_EVAL)      # (clips, samples, T)
    return s[:, 0].mean(0), s[:, 1:].mean((0, 1))


def _run_flag(run: str, name: str) -> int:
    with open(os.path.join(run, "manifest.json")) as f:
        flags = json.load(f)["train_flags"]
    return int(flags[flags.index(name) + 1])


def _clips(seed: int, loader_seed: int, n_eval: int, batch: int,
           step: int) -> np.ndarray:
    """The port's procedural Moving-MNIST test clips, (T, B, 64, 64)."""
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.data import Loader, load_dataset
    cfg = DVGConfig(dataset="smmnist", channels=1, image_width=64,
                    data_root="", seed=seed)
    loader = Loader(load_dataset(cfg, seq_len=n_eval, split="test"), batch,
                    shuffle=False, seed=loader_seed, num_threads=1,
                    device="cpu")
    try:
        return np.asarray(loader.next_batch(step), np.float32)[..., 0]
    finally:
        loader.stop()


def truth_error(run: str, tiles: np.ndarray, epoch: int) -> float:
    """max |ground-truth tile − the clip the port's training CLI plots at
    `epoch`| (its test loader, seeded seed + 1, batch `epoch`)."""
    seed = _run_flag(run, "--seed")
    x = _clips(seed, seed + 1, PLOT_N_EVAL, _run_flag(run, "--batch_size"),
               epoch)
    gt = tiles[:, 0]                                  # (clips, T, 64, 64)
    return float(np.abs(gt - np.swapaxes(x[:, :gt.shape[0]], 0, 1)).max())


def baselines(run: str, n_eval: int, batch: int) -> np.ndarray:
    """Mean SSIM by free step of two predictions that need no model on the
    run's eval batch 0: an all-black frame and the last context frame
    held, (2, n_eval - n_past)."""
    n_past = _run_flag(run, "--n_past")
    seed = _run_flag(run, "--seed")
    x = _clips(seed, seed, n_eval, batch, 0)
    fut, hw = x[n_past:], x.shape[2:]
    last = np.broadcast_to(x[n_past - 1], fut.shape)
    return np.stack([_ssim(fut.reshape(-1, *hw), p.reshape(-1, *hw))
                     .reshape(fut.shape[:2]).mean(1)
                     for p in (np.zeros_like(fut), last)])


def score(runs: list) -> str:
    lines = []
    for run in runs:
        name = os.path.relpath(run)
        pngs = sorted(glob.glob(os.path.join(run, "model", "sample_*.png")),
                      key=lambda p: int(p.rsplit("_", 1)[1][:-4]))
        for png in pngs:
            tiles = plot_tiles(png)
            best, rand = plot_profile(tiles)
            epoch = int(png.rsplit("_", 1)[1][:-4])
            lines.append(f"{name} {os.path.basename(png)} SSIM by frame "
                         f"(free from 5, a fork at 10): best of 5 "
                         + " ".join(f"{v:.3f}" for v in best[5:])
                         + " | random " + " ".join(f"{v:.3f}"
                                                   for v in rand[5:])
                         + f" | ground truth vs the port's test clips "
                         f"max|d| {truth_error(run, tiles, epoch):.1e}")
        npz = os.path.join(run, "eval", "eval_batch0.npz")
        if os.path.exists(npz):
            with np.load(npz) as z:
                ssim = z["ssim"]                          # (B, S, T')
            curve = ssim.mean(axis=(0, 1))
            n_past = 5
            base = baselines(run, n_past + curve.size, ssim.shape[0])
            lines.append(f"{name} eval batch 0 mean SSIM by free step "
                         f"(blank / copy-last): " + "  ".join(
                             f"t{t} {curve[t]:.3f} ({base[0, t]:.3f} / "
                             f"{base[1, t]:.3f})"
                             for t in SCORE_STEPS if t < curve.size))
            lines.append(f"{name} mean over steps {curve.mean():.4f} (blank "
                         f"{base[0].mean():.4f}, copy-last "
                         f"{base[1].mean():.4f})")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("soak", "cli", "score"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "soak":
        return run_soak(argv[1:])
    if argv[0] == "cli":
        return run_cli(argv[1], argv[2:])
    print(score(argv[1:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
