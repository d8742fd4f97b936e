#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`dvg_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on a mismatch:
  1. environment: card name and power limit, versions; builds every kernel
     of the port from the sources in this checkout and prints the build
     seconds and ptxas' resource lines;
  2. K1 (csrc/ssim_cyclic.cu) against its plain PyTorch version on the card
     at the headline step shape (gt (50,64,64,3) f32, pred (5000,64,64,3)
     bf16) and on identical images; times the kernel and the plain version;
  3. the tiny f32 config of `diverse_metrics`, card (kernel) against CPU
     (plain), same weights and noise, TF32 off;
  4. the main path: the bf16 headline eval protocol of `diverse_metrics`
     (DCGAN-64, S 100, B 50, n_past 5, n_eval 105) on random seeded
     weights — one warm-up run, then one timed run with every kernel's
     launch count set to 0 just before and read just after.
  5. a torch.profiler pass over one more protocol run: device time by
     kernel group and the card's busy share.
Then one JSON line describing every kernel of the port, and last the
device line.

Needs one card. Imports nothing of JAX and nothing of `dvg_tpu`.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

HEADLINE = dict(channels=3, image_width=64, g_dim=90, rnn_size=256,
                predictor_rnn_layers=2, num_inducing_points=40, n_past=5,
                n_eval=105, n_future=100, nsample=100, batch_size=50,
                dtype="bfloat16", use_pallas=True)
TINY = dict(channels=3, image_width=64, g_dim=16, rnn_size=64,
            num_inducing_points=8, n_past=2, n_eval=32, nsample=3,
            batch_size=2, dtype="float32", use_pallas=True)

K1_TOL = dict(ssim_atol=1e-4, psnr_atol=1e-3, mse_rtol=1e-5)
PATH_TOL = dict(ssim_atol=1e-4, psnr_atol=1e-3, mse_rtol=1e-4)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn over `reps` calls (after one warm-up), by CUDA
    events around the whole window."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_cost(n: int, b: int, h: int, w: int, c: int, pred_bytes: int,
            win: int = 7):
    """(bytes, f32 operations) K1 must at least move and do for one launch:
    each input read once (gt f32, pred, the gt mean and two gt moment maps),
    each output written once (three f32 per plane); per plane, staging and
    squared error (8 per pixel), running-sum 7-wide boxes of three moments
    in both directions (3 per output each), and the SSIM epilogue (25 per
    map pixel)."""
    hp, wp = h - win + 1, w - win + 1
    planes, gplanes = n * c, b * c
    nbytes = (n * h * w * c * pred_bytes + b * h * w * c * 4
              + gplanes * (1 + 2 * hp * wp) * 4 + 3 * planes * 4)
    flops = planes * (8 * h * w + 9 * h * wp + 9 * hp * wp + 25 * hp * wp)
    return nbytes, flops


def bound(nbytes: int, flops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_errs(got, ref):
    """(max |Δssim|, max |Δpsnr|, max rel Δmse, max |Δ| over all three)."""
    d = [(g.float() - r.float()).abs() for g, r in zip(got, ref)]
    rel = (d[2] / ref[2].float().abs().clamp(min=1e-30)).max().item()
    return d[0].max().item(), d[1].max().item(), rel, \
        max(x.max().item() for x in d)


def within(errs, tol) -> bool:
    s, q, m, _ = errs
    return s <= tol["ssim_atol"] and q <= tol["psnr_atol"] \
        and m <= tol["mse_rtol"]


def phase_environment():
    import torch
    from dvg_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    print(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}  nvcc {nvcc[-1] if nvcc else '?'}")
    print(f"[env] device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        t0 = time.perf_counter()
        log = _build.build(name)
        print(f"[build] {name}: {time.perf_counter() - t0:.2f} s "
              f"({'compiled' if log else 'cached'})")
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_k1():
    """K1 against its plain version at the headline step shape."""
    import torch
    from dvg_tpu_torch.ops import ssim as plain
    from dvg_tpu_torch.ops import ssim_cuda
    dev = torch.device("cuda")
    s_n, b, hw, c = HEADLINE["nsample"], HEADLINE["batch_size"], 64, 3
    g = torch.Generator(device=dev).manual_seed(0)
    gt = torch.rand((b, hw, hw, c), generator=g, device=dev)
    pred = (0.6 * gt.repeat(s_n, 1, 1, 1)
            + 0.4 * torch.rand((s_n * b, hw, hw, c), generator=g,
                               device=dev)).to(torch.bfloat16)
    got = ssim_cuda.ssim_psnr_batch_cyclic(gt, pred)
    torch.cuda.synchronize()
    ref = plain.ssim_psnr_cyclic_plain(gt, pred)
    errs = max_errs(got, ref)
    print(f"[k1] headline step {tuple(pred.shape)} bf16 vs plain: "
          f"max|dssim| {errs[0]:.3e}  max|dpsnr| {errs[1]:.3e} dB  "
          f"max rel dmse {errs[2]:.3e}  (tol {K1_TOL})")
    check(within(errs, K1_TOL), f"K1 disagrees with its plain version: {errs}")
    check(all(torch.isfinite(t).all() for t in got), "K1 output not finite")

    # identical images (gt bf16-representable): SSIM 1, MSE 0
    same = gt.to(torch.bfloat16)
    s_v, q_v, m_v = ssim_cuda.ssim_psnr_batch_cyclic(
        same.float(), same.repeat(4, 1, 1, 1))
    torch.cuda.synchronize()
    d1 = (s_v - 1).abs().max().item()
    print(f"[k1] identical images: max|ssim-1| {d1:.3e}  max mse "
          f"{m_v.max().item():.3e}  min psnr {q_v.min().item():.1f} dB")
    check(d1 <= 1e-4 and m_v.max().item() == 0.0, "K1 identical-image case")

    # f32 pred, as the f32 path hands it over
    pred32 = pred[:4 * b].float()
    errs32 = max_errs(ssim_cuda.ssim_psnr_batch_cyclic(gt, pred32),
                      plain.ssim_psnr_cyclic_plain(gt, pred32))
    print(f"[k1] f32 pred vs plain: {errs32[:3]}")
    check(within(errs32, K1_TOL), f"K1 f32 pred disagrees: {errs32}")

    mg, gux, gxx = plain.gt_box_moments(gt)
    k_ms = cuda_ms(lambda: ssim_cuda.launch(gt, pred, mg, gux, gxx), 20)
    w_ms = cuda_ms(lambda: ssim_cuda.ssim_psnr_batch_cyclic(gt, pred), 20)
    p_ms = cuda_ms(lambda: plain.ssim_psnr_cyclic_plain(gt, pred), 5)
    nbytes, flops = k1_cost(s_n * b, b, hw, hw, c, pred.element_size())
    b_ms, b_by = bound(nbytes, flops)
    print(f"[k1] kernel {k_ms * 1e3:.1f} us/launch  wrapper (with gt "
          f"precompute and channel mean) {w_ms * 1e3:.1f} us  plain "
          f"{p_ms * 1e3:.1f} us  bound {b_ms * 1e3:.1f} us by {b_by} "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)  "
          f"= {b_ms / k_ms:.1%} of bound")
    return dict(max_abs_err=errs[3], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by)


def unit_gain_model(cfg, device):
    """Seeded random weights rescaled to unit gain per layer (std
    1/√fan-in), so the GP draw visibly moves the frames and best-of-N has
    clear winners; at the init law's std 0.02 the samples differ by ~1e-7."""
    import torch
    from dvg_tpu_torch.models.dvg import DVGModel
    model = DVGModel(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.ConvTranspose2d):
                fan = m.weight.shape[0] * m.weight[0, 0].numel() // 4
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                fan = m.weight[0].numel()
            else:
                continue
            m.weight.mul_(1.0 / (0.02 * math.sqrt(fan)))
    return model.to(device)


def phase_tiny():
    """The tiny f32 config: card (kernel) against CPU (plain)."""
    import numpy as np
    import torch
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.generate.rollout import best_of_n, make_rollout_fns
    from dvg_tpu_torch.ops.ssim_cuda import ssim_psnr_batch_cyclic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DVGConfig(**TINY)
    n_free = cfg.n_eval - cfg.n_past
    rng = np.random.RandomState(0)
    x = (rng.rand(cfg.n_eval, cfg.batch_size, 64, 64, 3) * 2 - 1
         ).astype(np.float32)
    noise = rng.randn(n_free, cfg.nsample, cfg.batch_size,
                      cfg.g_dim).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = unit_gain_model(cfg, dev)
        ssim_psnr_batch_cyclic.launches = 0
        out = make_rollout_fns(model, cfg).diverse_metrics(x, noise=noise,
                                                           device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = ssim_psnr_batch_cyclic.launches
        outs[dev] = {k: v.cpu() for k, v in out.items()}
    cpu, card = outs["cpu"], outs["cuda"]
    errs = max_errs([card[k] for k in ("ssim", "psnr", "mse")],
                    [cpu[k] for k in ("ssim", "psnr", "mse")])
    idx_card, _ = best_of_n(card["ssim"].permute(2, 0, 1))
    idx_cpu, best = best_of_n(cpu["ssim"].permute(2, 0, 1))
    means = cpu["ssim"].mean(1).sort(0).values
    gap = (means[-1] - means[-2]).min().item()
    print(f"[tiny] card vs cpu f32 (S,n_free,B)={tuple(card['ssim'].shape)}: "
          f"max|dssim| {errs[0]:.3e}  max|dpsnr| {errs[1]:.3e} dB  max rel "
          f"dmse {errs[2]:.3e}  (tol {PATH_TOL});  K1 launches {launches}; "
          f"best-of-N card {idx_card.tolist()} cpu {idx_cpu.tolist()} "
          f"(smallest best-vs-next gap {gap:.2e})")
    check(within(errs, PATH_TOL), f"tiny config card vs CPU: {errs}")
    check(launches == n_free, f"K1 launched {launches} times, not {n_free}")
    check(torch.equal(idx_card, idx_cpu), "best-of-N indices differ")


def phase_main():
    """The main path at full width, bf16."""
    import torch
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.generate.rollout import best_of_n, make_rollout_fns
    from dvg_tpu_torch.models.dvg import DVGModel
    from dvg_tpu_torch.ops.ssim_cuda import ssim_psnr_batch_cyclic
    torch.backends.cudnn.benchmark = True
    cfg = DVGConfig(**HEADLINE)
    s_n, b, n_free = cfg.nsample, cfg.batch_size, cfg.n_eval - cfg.n_past
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = DVGModel(cfg, seed=0, device="cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((cfg.n_eval, b, 64, 64, 3), generator=g, device=dev)
    fns = make_rollout_fns(model, cfg)
    fns.diverse_metrics(x, seed=2)                       # warm-up
    torch.cuda.synchronize()
    print(f"[main] set-up + warm-up {time.perf_counter() - t0:.2f} s "
          "(cudnn.benchmark on)")

    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ssim_psnr_batch_cyclic.launches = 0
    t0 = time.perf_counter()
    start.record()
    out = fns.diverse_metrics(x, seed=3)
    end.record()
    torch.cuda.synchronize()
    launches = ssim_psnr_batch_cyclic.launches
    host_s = time.perf_counter() - t0
    ms = start.elapsed_time(end)
    frames = s_n * n_free * b
    finite = all(torch.isfinite(v).all().item() for v in out.values())
    print(f"[main] DCGAN-64 bf16 S {s_n} B {b} n_free {n_free}: "
          f"{ms:.1f} ms/protocol (events), {host_s * 1e3:.1f} ms host, "
          f"{frames / (ms / 1e3):,.0f} frames/s; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"K1 launches {launches}; finite {finite}")
    for k, v in out.items():
        check(tuple(v.shape) == (s_n, n_free, b), f"{k} shape {v.shape}")
    check(finite, "non-finite metric in the main path")
    check(launches == n_free, f"K1 launched {launches} times, not {n_free}")
    idx, best = best_of_n(out["ssim"].permute(2, 0, 1))
    check(bool(((idx >= 0) & (idx < s_n)).all()), "best-of-N index range")
    print(f"[main] mean ssim {out['ssim'].mean().item():.5f}  mean psnr "
          f"{out['psnr'].mean().item():.4f} dB  mean mse "
          f"{out['mse'].mean().item():.5f}  best-of-N mean ssim "
          f"{best.mean().item():.5f}")
    return fns, x, launches


KERNEL_GROUPS = (("K1 ssim_cyclic", ("ssim_cyclic",)),
                 ("transposed conv (dgrad)", ("dgrad",)),
                 ("conv (fprop)", ("fprop", "cutlass")),
                 ("cuDNN layout/padding", ("Padding", "ToNhwc", "ToNchw")),
                 ("elementwise (bias, skip add, leaky_relu, tanh)",
                  ("elementwise",)))


def phase_profile(fns, x):
    """Device time by kernel group over one protocol run, and the card's
    busy share of its first-to-last-kernel span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        fns.diverse_metrics(x, seed=4)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    print(f"[profile] {len(kernels)} kernels, device busy {busy:.1f} ms of "
          f"a {span:.1f} ms span ({busy / span:.1%})")
    rest = busy
    for group, keys in KERNEL_GROUPS:
        ms = sum(e.time_range.elapsed_us() for e in kernels
                 if any(k in e.name for k in keys)) / 1e3
        rest -= ms
        print(f"[profile] {ms:9.2f} ms ({ms / busy:6.1%})  {group}")
    print(f"[profile] {rest:9.2f} ms ({rest / busy:6.1%})  other (LSTM, GP, "
          "reductions, copies)")
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile] top {ms:9.2f} ms {n:5d}x  {name[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import dvg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the dvg_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    try:
        phase_environment()
        k1 = phase_k1()
        phase_tiny()
        fns, x, launches = phase_main()
        phase_profile(fns, x)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [dict(name="ssim_cyclic", route="cuda",
                    source="dvg_tpu_torch/csrc/ssim_cyclic.cu",
                    replaces="dvg_tpu/ops/pallas_ssim.py:187",
                    launches=launches, max_abs_err=k1["max_abs_err"],
                    ms=k1["ms"], plain_ms=k1["plain_ms"],
                    bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
                    library_ms=None)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
