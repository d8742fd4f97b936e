"""Does a precision difference of the JAX package explain its soak's scores?

Two emulations, each making the port compute one thing as `dvg_tpu` did:

  * `tpu_dots()`: XLA on a TPU runs an f32 contraction (dot, einsum,
    tensordot) at its DEFAULT precision, one pass with both operands
    rounded to bf16 and an f32 accumulator. In the bf16 recipe the convs
    and the LSTM already compute in bf16 in both packages; the f32 islands
    (the GP's products, the BN statistics' fold) run in f32 on the card but
    at bf16 operand precision on the TPU. Under it every f32
    `torch.einsum`, `torch.bmm`, `torch.matmul`, `torch.mm` and `@` rounds
    its operands to bf16 (differentiably: the backward rounds each
    operand's gradient the same way) and accumulates in f32. Cholesky
    factors and triangular solves stay exact.
  * `xla_bias_sum()`: dvg_tpu's bf16 step adds the decoder's last bias in
    bf16 (dvg_tpu/models/dcgan.py:192), and XLA:CPU sums that add's
    cotangent with bf16 partial sums: a reduce-window of 32 along each
    reduced dim longer than 32, each window summed element by element,
    then the windows (`xla_cpu_sum`, bit-equal to XLA:CPU on the same
    cotangent). Under it the port's train step sums that gradient the same
    way; the forward is unchanged.

    python experiments/tpu_precision.py soak [--emulate dots|bias] --out RUN
            [soak flags]
        the soak driver (dvg_tpu_torch.cli.soak) with every CLI it runs
        under the emulation (default dots); its manifest gains an
        "emulation" entry
    python experiments/tpu_precision.py cli [--emulate dots|bias] MODULE
            [flags]
        one CLI module (dvg_tpu_torch.cli.train, ...) under the emulation
    python experiments/tpu_precision.py score RUN [RUN ...]
        per run, the epoch plots' (model/sample_<e>.png) mean SSIM by
        frame, their ink (mean predicted over mean ground-truth intensity)
        by free frame and their ground-truth rows' distance from the port's
        test clips, and eval batch 0's mean SSIM by free step beside the
        blank-frame and copy-last-frame predictions of the same clips

`score` runs on the CPU; the others on the card unless given --device cpu.
`xla_bias_sum()` builds a small C++ library with g++ into
experiments/build/ at first use.
"""

from __future__ import annotations

import functools
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


XLA_WINDOW = 32   # XLA:CPU's TreeReductionRewriter: reduce-window width
BUILD = os.path.join(REPO, "experiments", "build")

_SUM_SRC = r"""
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

static inline float f32(uint16_t h) {
  uint32_t u = uint32_t(h) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// f32 -> bf16, round to nearest even (XLA's convert)
static inline uint16_t bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return uint16_t((u >> 16) | 0x40u);
  return uint16_t((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// out[o, c]: the bf16 sum of window o of x's four reduced dims for channel
// c, element by element in row-major order, each add in f32 and rounded to
// bf16. Window o spans [o[d]·window[d] − pad[d], +window[d]) along dim d
// (size[d] elements, stride[d]); positions outside x are skipped.
extern "C" void xla_window_sums(const uint16_t* x, const int64_t* size,
                                const int64_t* stride, int64_t channels,
                                int64_t cstride, const int64_t* window,
                                const int64_t* pad, const int64_t* n_out,
                                uint16_t* out, int threads) {
  const int64_t total = n_out[0] * n_out[1] * n_out[2] * n_out[3] * channels;
  auto work = [&](int64_t first) {
    for (int64_t k = first; k < total; k += threads) {
      int64_t o = k / channels, lo[4];
      const uint16_t* xc = x + (k % channels) * cstride;
      for (int d = 3; d >= 0; --d) {
        lo[d] = (o % n_out[d]) * window[d] - pad[d];
        o /= n_out[d];
      }
      uint16_t acc = 0;
      for (int64_t i0 = lo[0]; i0 < lo[0] + window[0]; ++i0) {
        if (i0 < 0 || i0 >= size[0]) continue;
        for (int64_t i1 = lo[1]; i1 < lo[1] + window[1]; ++i1) {
          if (i1 < 0 || i1 >= size[1]) continue;
          for (int64_t i2 = lo[2]; i2 < lo[2] + window[2]; ++i2) {
            if (i2 < 0 || i2 >= size[2]) continue;
            const uint16_t* row = xc + i0 * stride[0] + i1 * stride[1]
                                  + i2 * stride[2];
            for (int64_t i3 = lo[3]; i3 < lo[3] + window[3]; ++i3) {
              if (i3 < 0 || i3 >= size[3]) continue;
              acc = bf16(f32(acc) + f32(row[i3 * stride[3]]));
            }
          }
        }
      }
      out[k] = acc;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& t : pool) t.join();
}
"""
@functools.cache
def _window_sums_lib():
    """`_SUM_SRC` built with g++ into experiments/build/ on first use."""
    import ctypes
    import hashlib
    import subprocess
    digest = hashlib.sha256(_SUM_SRC.encode()).hexdigest()[:16]
    path = os.path.join(BUILD, f"xla_sum-{digest}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD, exist_ok=True)
        src = os.path.join(BUILD, f"xla_sum-{digest}.{os.getpid()}.cpp")
        with open(src, "w") as f:
            f.write(_SUM_SRC)
        tmp = src[:-4] + ".so"
        subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                        "-pthread", "-o", tmp, src], check=True)
        os.replace(tmp, path)
        os.remove(src)
    lib = ctypes.CDLL(path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.xla_window_sums.argtypes = [
        ctypes.c_void_p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p,
        i64p, i64p, ctypes.c_void_p, ctypes.c_int]
    lib.xla_window_sums.restype = None
    return lib


def tree_windows(size: int) -> tuple:
    """XLA:CPU's reduce-window along one reduced dim of `size` elements:
    (width, low padding, windows). A dim of up to XLA_WINDOW elements is one
    window; a longer one is padded to whole windows, the low side taking
    the smaller half."""
    if size <= XLA_WINDOW:
        return size, 0, 1
    n = -(-size // XLA_WINDOW)
    return XLA_WINDOW, (n * XLA_WINDOW - size) // 2, n


def xla_cpu_sum(g):
    """The sum over the first four dims of a (N, B, H, W, C) bf16 tensor
    (any strides, any device) as XLA:CPU computes a bf16 reduce_sum: the
    TreeReductionRewriter's reduce-window sums (`tree_windows` along each
    dim, each window element by element with bf16 partial sums), then those
    sums in order, in bf16 → (C,) bf16 on g's device. At least one of the
    four dims must exceed XLA_WINDOW (H, W 64 do), or XLA reduces at
    once."""
    import ctypes
    import torch
    if g.dtype != torch.bfloat16 or g.dim() != 5:
        raise ValueError(f"want a 5-d bf16 tensor, got {g.dtype} "
                         f"{tuple(g.shape)}")
    x = g.detach().cpu()
    wins = [tree_windows(s) for s in x.shape[:4]]
    n_out = [w[2] for w in wins]
    out = torch.empty(n_out + [x.shape[4]], dtype=torch.bfloat16)

    def arr(v):
        return (ctypes.c_int64 * len(v))(*v)

    _window_sums_lib().xla_window_sums(
        x.data_ptr(), arr(x.shape[:4]), arr(x.stride()[:4]), x.shape[4],
        x.stride(4), arr([w[0] for w in wins]), arr([w[1] for w in wins]),
        arr(n_out), out.data_ptr(), min(os.cpu_count() or 1, out.numel()))
    acc = torch.zeros(x.shape[4], dtype=torch.bfloat16)
    for part in out.reshape(-1, x.shape[4]):
        acc = (acc.float() + part.float()).to(torch.bfloat16)
    return acc.to(g.device)


def xla_bias_sum() -> None:
    """From here on, the train step's bf16 decode (`Decoder.grouped`) sums
    the cotangent of its last-stage bias add as dvg_tpu's step does on
    XLA:CPU (`xla_cpu_sum`; dvg_tpu/models/dcgan.py:192), not in f32 as
    autograd does. The forward stays bit-equal: the port's add of the bias
    becomes an exact `+ 0`, and `_XlaBiasAdd` adds the bias right after
    it, before the final activation."""
    import torch
    from dvg_tpu_torch.models import dcgan

    grouped, logged = dcgan.Decoder.grouped, []

    class _XlaBiasAdd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, bias, calls):     # y (calls·B, C, H, W)
            ctx.calls = calls
            return y + bias[:, None, None]

        @staticmethod
        def backward(ctx, g):
            g5 = g.unflatten(0, (ctx.calls, -1)).permute(0, 1, 3, 4, 2)
            got = xla_cpu_sum(g5)
            if not logged:
                logged.append(1)
                print(f"[xla_bias_sum] decoder.final.bias gradient over "
                      f"{tuple(g5.shape)}: XLA:CPU's sum "
                      f"{got.float().tolist()}, f32 sum "
                      f"{g5.float().sum((0, 1, 2, 3)).tolist()}", flush=True)
            return g, got, None

    def patched(self, vecs, skips_u, group_idx, dtype=None, group=None):
        if dtype != torch.bfloat16:
            return grouped(self, vecs, skips_u, group_idx, dtype, group)
        final, activate = self.final, dcgan.activate
        bias = final.bias
        final._parameters["bias"] = torch.zeros_like(bias)
        # `grouped` applies only its final activation through `activate`
        dcgan.activate = lambda y, act: activate(_XlaBiasAdd.apply(
            y, bias.to(dtype), vecs.shape[0]), act)
        try:
            return grouped(self, vecs, skips_u, group_idx, dtype, group)
        finally:
            final._parameters["bias"], dcgan.activate = bias, activate

    dcgan.Decoder.grouped = patched


EMULATIONS = {
    "dots": (tpu_dots, "experiments/tpu_precision.py tpu_dots(): f32 "
             "contractions at bf16 operand precision, as XLA's DEFAULT on a "
             "TPU"),
    "bias": (xla_bias_sum, "experiments/tpu_precision.py xla_bias_sum(): "
             "the decoder's last-stage bias gradient summed in bf16 as "
             "dvg_tpu's step does on XLA:CPU"),
}


def _emulation(argv: list) -> tuple:
    """A leading `--emulate {dots,bias}` (default dots) → (name, the rest)."""
    if argv[:1] == ["--emulate"]:
        if len(argv) < 2 or argv[1] not in EMULATIONS:
            raise SystemExit(f"--emulate takes one of {sorted(EMULATIONS)}")
        return argv[1], argv[2:]
    return "dots", argv


def run_cli(emulate: str, module: str, argv: list) -> int:
    EMULATIONS[emulate][0]()
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        return int(e.code or 0)
    return 0


def run_soak(emulate: str, argv: list) -> int:
    from dvg_tpu_torch.cli import soak
    rc = soak.main(argv, launcher=[sys.executable, os.path.abspath(__file__),
                                   "cli", "--emulate", emulate])
    out = soak.build_parser().parse_args(argv).out
    path = os.path.join(out, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["emulation"] = EMULATIONS[emulate][1]
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


def ink_profile(tiles: np.ndarray) -> np.ndarray:
    """`plot_tiles`' grid → mean intensity of all samples over that of the
    ground truth, by frame, (n_eval,)."""
    return tiles[:, 1:].mean(axis=(0, 1, 3, 4)) / tiles[:, 0].mean(
        axis=(0, 2, 3))


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
            fut = tiles[:, :, 5:]
            lines.append(f"{name} {os.path.basename(png)} ink (predicted / "
                         "ground-truth mean intensity) by free frame "
                         + " ".join(f"{v:.3f}" for v in ink_profile(tiles)[5:])
                         + " | over the free frames "
                         f"{fut[:, 1:].mean() / fut[:, 0].mean():.3f}")
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
        return run_soak(*_emulation(argv[1:]))
    if argv[0] == "cli":
        emulate, rest = _emulation(argv[1:])
        return run_cli(emulate, rest[0], rest[1:])
    print(score(argv[1:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
