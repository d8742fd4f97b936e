#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`dvg_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on a mismatch:
  1. environment: card name and power limit, versions; builds every kernel
     of the port from the sources in this checkout and prints the build
     seconds and ptxas' registers and spills per kernel instance (a spill
     fails the run once the other phases have run);
  2. K1 (csrc/ssim_cyclic.cu, cyclic gt) against its plain PyTorch version
     on the card at the headline step shape (gt (50,H,H,3) f32, pred
     (5000,H,H,3) bf16) at H = 64 and 128, on identical images and with
     f32 pred; times the kernel, its wrapper and the plain version, with
     the bound, the share of it, the sample group G and the resident
     blocks per SM;
  3. K2 (the same template, one-to-one) against its plain version at 5000
     image pairs of H×H×3, H = 64 and 128, pred bf16 and f32, and on
     identical images; the same timings;
  3b. K3 (csrc/conv_epilogue.cu, the conv epilogue) against its plain
     version at the VGG-128 eval's largest maps, every activation, with
     and without the skip half (leaky and none bitwise equal, tanh and
     sigmoid within 1 bf16 ulp; the largest |got - plain| is the entry's
     max_abs_err); times the kernel, its wrapper, the plain version and
     the stock chain it replaced, with the HBM bound; then K3's pooled
     form at (800, 64, 128, 128) -> (800, 64, 64, 64) bf16 against its
     plain version and max_pool2d of the plain epilogue, timed beside its
     byte bound and the K3 + max_pool2d pair it replaces;
  3c. [resample] the five folded up halves of VGG-128's decoder (stride-2
     transposed convs of the small maps, 800 frames, bf16 channels_last,
     cuDNN autotuned) against the nearest upsample + 3×3 conv each
     replaces: µs of each, the output's layout, the largest difference;
  3d. [k4] K4 (csrc/bn_act.cu, train-mode BatchNorm and its activation) at
     the DCGAN-64 train cell's maps in bf16 and f32: statistics against
     the plain chain's, the apply bitwise given them, the backward against
     the plain formula; each of its four kernels timed beside its byte
     bound, the forward and forward + backward beside the plain chain and
     F.batch_norm(training=True) + the activation (a yardstick only); then
     the train cell's step at B 100: K4's 46 launches a step (gated, by
     the counter and in a profiled step), ms a step, peak memory, device
     time by group;
  4. checkpoint: writes the headline DCGAN-64 model from seeded weights in
     the dvg_tpu format and reads it back, every leaf equal; the later
     phases load their model from this file;
  5. the tiny f32 config of `diverse_metrics`, card (kernel) against CPU
     (plain), same weights and noise, TF32 off;
  6. the rest of generation on the tiny f32 config, card against CPU, with
     the seeded noise (`fork_noise`): `posterior`, `gp_trigger` (equal
     trigger masks, at a margin whose nearest decision is far from its
     threshold), `diverse_metrics`, and the exact re-roll — the futures
     `diverse_select_pairs` re-rolls, scored by K2, give the scores K1 gave
     them inside `diverse_metrics`;
  7. the main path: the bf16 headline eval protocol of `diverse_metrics`
     (DCGAN-64, S 100, B 50, n_past 5, n_eval 105) on the checkpoint's
     weights — one warm-up run, then one timed run with every kernel's
     launch count set to 0 just before and read just after: K1 once per
     free step, K3 once per folded conv (`k3_per_call`: 5 a pass, 1,005 a
     call);
  8. the rest of generation at that width: `posterior`, `gp_trigger`, and
     the eval CLI's re-roll of 40 (sample, row) pairs (10 rows × [best + 3
     random]) scored by K2 — the K2 path, its counts set to 0 just before
     and read just after;
  9. a torch.profiler pass over one more protocol run: device time by
     kernel group and the card's busy share;
 10. [cli] the eval CLI (`dvg_tpu_torch.cli.generate.main`) in-process at
     full width from a DCGAN-64 smmnist checkpoint (channels 1, unit gain)
     on procedural digits, two batches, in f32 and in bf16: wall seconds
     of each stage, K1 launches per batch (100) with every count set to 0
     just before each run and read just after, peak memory, the npz
     shapes, 10 GIFs and an eval record per batch, and the best-SSIM
     column's frames (held before GIF encoding) re-scored by K2 against
     the batch's ground truth equal to the npz scores; K1 alone at C 1;
     the GP-trigger run (50 strips, every decision firing at a positive
     margin on the seeded GP's constant variance); the Finn and
     kernel-free metric routes card against CPU on the tiny config, and
     timed at full width beside K1's; and no PIL or imageio imported;
 11. [train] the train step (`dvg_tpu_torch.train`), which launches
     neither kernel: (a) on a tiny config (B 8, T 6, g_dim 16), the
     card's step in f64 and in f32 against the CPU's in f64, from the same
     weights and clip, TF32 off and cuDNN deterministic: the joint pass's
     metrics and gradients at the init, the statistics its fold leaves,
     the finetune passes' losses, gradients and encode statistics at the
     CPU's post-joint parameters, and the post-step encoder and decoder
     wherever their gradient's sign is not rounding; in f32 a tensor the
     clip makes ill-conditioned (its f64 gradient moves far under an
     f32-sized perturbation, printed) is held to 100× that movement;
     (b) at the bench's training geometry (DCGAN-64, 3 channels, B 50, T
     15, g_dim 90, rnn 256×2, 40 inducing points, finetune passes on) in
     f32 and bf16: ms per step by CUDA events over 20 pipelined steps on
     one fixed batch after a warm-up step, peak memory, the bound and the
     share of it, device time by kernel group, every metric finite and the
     joint loss lower after the 20 steps than at step 0; (c) the training
     CLI in-process on procedural smmnist digits at full width: 2 epochs
     of 10 steps, a resumed third epoch from step 20, and the eval CLI
     scoring the trained checkpoint with K1 launched 100 times per batch;
 12. [backbones] VGG-64, VGG-128 and DCGAN-128: (a) on tiny configs, card
     against CPU, f32 `diverse_metrics` (K1 on the card, its plain version
     on the CPU) and one f64 train step; (b) at full width in bf16, from
     seeded weights written as a dvg_tpu checkpoint and read back, the
     protocol (S 100, n_past 5, n_eval 105) on VGG-128 and DCGAN-128 at
     bench.py's 128 px batch 8 and on VGG-64 at batch 50: ms and frames/s
     of one timed run after a warm-up, K1 launches (100) and K3's
     (`k3_per_call`: 2,814 on VGG-128), counts set to 0 just before and
     read just after, peak memory, the card's busy share
     and K1's µs per launch on the model's frames, device time by kernel
     group, and the bound from the FLOPs counted; the VGG-128 train step
     (bf16, B 8, T 15, --remat) over 20 pipelined steps, and one profiled; (c) the training CLI at --model vgg
     --image_width 128 --remat --dtype bfloat16 for one short epoch, then
     the eval CLI on its checkpoint: K1 100 launches per batch at 128 px,
     C 1, and K2 scoring the re-roll;
 13. [import] the reference user's path: (a) per backbone at a tiny width
     (g_dim 16, B 2, n_eval 12), a reference-schema model.pth written
     from seeded unit-gain weights, imported by the port on the card, its
     f32 posterior against the reference's posterior loop over the
     modules unpickled from the same file, on the card (FRAME_ATOL); (b)
     the same for DCGAN-64 at the bench's width (C 3, g_dim 90, rnn
     256×2, 40 inducing points) at B 50, the import timed; (c) 100
     synthetic BAIR trajectories of 30 frames written as softmotion-style
     TFRecords, converted by `convert_bair` (timed), the tree decoded by
     the numpy decoder and, where it can be built, the native one (frames/s
     and max |Δ|; where it cannot, the reason); (d) the eval CLI in bf16
     on the imported checkpoint and the converted data (S 100, B 50, n_past
     2, n_eval 30, 2 batches): K1 28 launches per batch, the clips equal
     to the written frames, the GIFs' best column re-scored by K2 against
     the npz (CLI_TOL), no PIL or imageio, stage seconds and frames/s;
 14. [dist] the parallel layer (`dvg_tpu_torch.parallel`), its ranks
     spawned as processes that join over the DVG_* env, each with its own
     log, a failing rank failing the phase: (a) NCCL at world size 1: the
     tiny f64 train step through the group path against the same step
     without a group (metrics and gradients 1e-12, the post-step state at
     phase 11a's 1e-9) and the ("sample", 1)-sharded tiny eval against
     the plain call; (b) two ranks sharing the card over gloo with CUDA
     tensors: the tiny f64 step, 2 × B 4 against one process on B 8
     (1e-9); the main path's protocol (DCGAN-64 from the phase-4
     checkpoint, whose bytes every rank reads from rank 0) sample-sharded,
     S 50 per rank, B 50, in f32 against one process (SSIM 1e-5, PSNR 1e-3
     dB, MSE rtol 1e-5) and in bf16 timed (ms per rank, frames/s of the
     pair, peak per rank) with its drift from phase 7's run (CLI_TOL's bf16
     band), K1 launched 100 times and K3 1,005 times per rank with their
     counts set to 0 just before (K3 counted in (a) and (c) too); (d) the
     training CLI --mesh 2 --dist_backend gloo at the
     bench's geometry on smmnist in bf16, 2 epochs of 5 steps, then a
     resumed third, each rank writing to its own directory (rank 1's stays
     empty), then the eval CLI --mesh_samples 2 (1 batch) on rank 0's
     checkpoint: K1 100 launches per rank, the GIFs' best column
     re-scored by K2 against the npz; (c) four ranks over gloo: the
     ("sample", 2) × ("data", 2) tiny eval against one process and the
     full_cov guard. Two ranks sharing one card are no speedup: the times
     show the gloo hops' cost;
 15. [serve] the serving export (`dvg_tpu_torch.serve`): the phase-4
     checkpoint's diverse_metrics and posterior, and gp_trigger of the
     headline model at unit gain with a trained-looking GP (on the init
     law's weights the GP's variance hardly moves), exported by the CLI
     `python -m dvg_tpu_torch.serve.export` at the headline geometry
     (bf16, K1; export seconds and MB of each), beside them in f32 at a
     cut depth (n_eval 20, a fork at step 15) the ("sample", 2) per-rank
     diverse_metrics artifact, the four exports side by side. One fresh
     process loads the three bf16 artifacts as their exports end (load
     seconds; it imports nothing of `models/`, `generate/` or JAX); the
     sharded artifact runs on two gloo ranks sharing the card; then a
     fresh process calls the live entries, and after it the artifacts'
     process calls the artifacts, both with cuDNN's autotuner off: ms per
     call by CUDA events over SERVE_REPS calls after a warm-up, K1's,
     K2's and K3's counts set to 0 just before and read just after. Gates:
     K1 100 and K3 1,005 launches per call from inside the diverse_metrics
     artifact (K1's µs per launch there), K2 none, each artifact's K3
     count equal to its live entry's, the sharded artifact's per rank at
     the cut depth; bf16 diverse_metrics within
     SERVE_BF16_TOL of the live entry, posterior's and gp_trigger's
     frames within SERVE_BF16_FRAME_ATOL, gp_trigger's decisions all
     equal; the sharded f32 artifact within SERVE_F32_TOL of the live
     entry.
 16. [soak quick] the training soak's CLI, `python -m
     dvg_tpu_torch.cli.soak --quick`, as a user runs it: the training CLI
     at the recipe's width (DCGAN-64, C 1, g_dim 90, rnn 256×2, bf16, B
     100) for 2 epochs of 25 steps, the eval CLI (8 futures, n_eval 20, 2
     batches of 50) and the GP-trigger run, each a subprocess: the
     summary, wall seconds and K1's launches per eval batch (15, as the
     eval CLI logs them); then `trained_checks` on its checkpoint: K1 and
     K2 against plain on the model's bf16 frames at the main path's shapes
     (TRAINED_TOL), and posterior, diverse_metrics and gp_trigger card
     against CPU in f32 over TRAINED_CUT frames (FRAME_ATOL, PATH_TOL,
     values 1e-4). The full soak's checkpoint goes through the same
     function in a command of its own.
Each phase prints its seconds. Then one JSON line describing every kernel
of the port, and last the device line.

Needs one card. Imports nothing of JAX and nothing of `dvg_tpu`.
"""

from __future__ import annotations

import copy
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CARD = "cuda"

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

K2_IMAGES = 5000          # one-to-one pairs in the K2 phase
SIDES = (64, 128)         # image sides of the kernel phases: DCGAN-64, -128
GIF_ROWS = 10             # the eval CLI's re-roll: rows × [best + 3 random]
MAIN_MS_BEFORE = 1490.3   # PERF.md §5: the protocol with per-plane kernels
MAIN_SEED = 3             # the main run's seed, which the re-roll replays

# the eval CLI's checkpoint: DCGAN-64 on smmnist (channels 1), saved
# geometry; the CLI applies the protocol override (n_eval 105, B 50)
CLI_MODEL = dict(dataset="smmnist", channels=1, image_width=64, g_dim=90,
                 rnn_size=256, predictor_rnn_layers=2,
                 num_inducing_points=40, n_past=5, n_future=10, n_eval=15)
CLI_BATCHES = 2           # batch 1 is warm
# the best column re-scored by K2 against the npz scores. In bf16 the
# 40-pair re-roll and the scored batch of 5,000 can take different cuDNN
# kernels (the encoder's skips differ by a bf16 ulp between the two batch
# sizes, with cudnn.benchmark and cudnn.deterministic on or off), so the
# re-rolled future is the scored one to bf16 rounding: the first [cli] run
# measured 3.6e-4 SSIM and 6.6e-4 dB there. f32 holds 1e-5 and 1e-3 dB.
CLI_TOL = {"float32": dict(ssim_atol=1e-5, psnr_atol=1e-3),
           "bfloat16": dict(ssim_atol=1e-3, psnr_atol=5e-3)}
# the Finn and kernel-free routes card against CPU (tests/test_torch_rollout)
ROUTE_TOL = dict(ssim_atol=5e-4, psnr_atol=1e-2, mse_rtol=1e-3)
ROUTES = (("K1", {}), ("finn", dict(eval_metric="finn")),
          ("no_kernel", dict(use_pallas=False)))

# the [train] phase: the card's f32 step against the CPU's f64 one
TRAIN_TINY = dict(channels=3, image_width=64, g_dim=16, rnn_size=64,
                  num_inducing_points=8, n_past=3, n_future=3, batch_size=8,
                  epoch_size=5)
TRAIN_TINY_SEED = 5       # the tiny clip
TRAIN_TOL = dict(metric_rtol=1e-4, grad_rel=1e-4, stats_atol=1e-5,
                 param_atol=1e-5)
# the JAX bench's training geometry
TRAIN_FULL = dict(channels=3, image_width=64, g_dim=90, rnn_size=256,
                  predictor_rnn_layers=2, num_inducing_points=40, n_past=5,
                  n_future=10, batch_size=50, epoch_size=300)
TRAIN_STEPS = 20
TRAIN_CLI_EPOCH = 10      # steps per epoch of the CLI run
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores

# [backbones]: the tiny configs (a fork at step 15), the full-width
# protocol's batch per backbone (bench.py:67-74: 8 at 128 px) and the
# VGG-128 train step, the JAX bench's vgg128 training cell (bench.py:437,
# 489) at the training geometry above
BACKBONES = (("VGG-128", dict(model="vgg", image_width=128), 8),
             ("DCGAN-128", dict(model="dcgan", image_width=128), 8),
             ("VGG-64", dict(model="vgg", image_width=64), 50))
BB_TINY = dict(TINY, n_eval=17)
BB_TRAIN_TINY = dict(channels=3, g_dim=16, rnn_size=64,
                     num_inducing_points=8, n_past=2, n_future=1,
                     batch_size=2, epoch_size=5)
BB_F64_TOL = dict(metric_rtol=1e-9, grad_rel=1e-9, param_atol=1e-8,
                  var_rtol=1e-6)
BB_TRAIN = dict(TRAIN_FULL, model="vgg", image_width=128, batch_size=8,
                dtype="bfloat16", remat=True)
BB_CLI_STEPS = 5          # steps of the training CLI's one epoch
# the eval CLI's bf16 re-roll on VGG-128 re-scored against the npz: the
# 32-pair re-roll and the 800-row scored batch take different cuDNN
# kernels, and 100 steps of a 26-conv backbone carry their bf16 rounding
# further than DCGAN-64's (CLI_TOL): two runs measured 3.0e-3 and 6.3e-3
# SSIM, 1.2e-2 and 1.6e-2 dB; the band is ~3x the larger. In f32 the
# re-roll is exact ([backbones tiny], REROLL_TOL)
BB_CLI_TOL = dict(ssim_atol=2e-2, psnr_atol=5e-2)
CARD_LINE = ""            # nvidia-smi's name and power limit

K1_TOL = dict(ssim_atol=1e-4, psnr_atol=1e-3, mse_rtol=1e-5)
PATH_TOL = dict(ssim_atol=1e-4, psnr_atol=1e-3, mse_rtol=1e-4)
# a re-roll scored by K2 against the same future scored by K1 in the loop
REROLL_TOL = dict(ssim_atol=1e-5, psnr_atol=1e-3, mse_rtol=1e-4)
FRAME_ATOL = 1e-4
# K3's launches per encode or decode pass of each backbone (its folded convs)
K3_PER_PASS = {("dcgan", 64): 5, ("dcgan", 128): 6, ("vgg", 64): 11,
               ("vgg", 128): 14}
# of them, the pooled form's per encode without skips (VGG's groups)
POOL_PER_ENCODE = {("vgg", 64): 4, ("vgg", 128): 5}
# VGG-128's eval at 800 frames: the pooled map K3's pooled form is timed on
POOL_SHAPE = (800, 64, 128, 128)
# K4 at the DCGAN-64 train cell's maps (B 100): (shape, calls) of the
# encode's first stage (15 frames), the grouped decode's last stage (42
# calls), the 90-channel encoder head and the decoder head
K4_SHAPES = (((1500, 64, 32, 32), 15), ((4200, 64, 32, 32), 42),
             ((1500, 90, 1, 1), 15), ((4200, 512, 4, 4), 42))
# the train cell's step (benchmark/configs/dcgan64_smmnist.json, traffic
# train): 14 BN forwards (5 joint encode, 4 grouped decode, 5 finetune
# encode) and 9 backwards, two launches each
K4_STEP = dict(channels=1, image_width=64, g_dim=90, rnn_size=256,
               predictor_rnn_layers=2, num_inducing_points=40, n_past=5,
               n_future=10, batch_size=100, epoch_size=300, ft=True,
               dtype="bfloat16")
K4_PER_STEP = 46
K4_STEPS = 10             # steps timed by events after the counted one

# [import]: reference-schema .pth files of each backbone at a tiny width
# and of DCGAN-64 at the bench's (BAIR: C 3, n_past 2), the BAIR data
IMPORT_TINY = dict(dataset="bair", channels=3, g_dim=16, rnn_size=64,
                   num_inducing_points=8, n_past=2, n_future=10, n_eval=12,
                   batch_size=2)
IMPORT_BACKBONES = (("DCGAN-64", dict(model="dcgan", image_width=64)),
                    ("DCGAN-128", dict(model="dcgan", image_width=128)),
                    ("VGG-64", dict(model="vgg", image_width=64)),
                    ("VGG-128", dict(model="vgg", image_width=128)))
IMPORT_FULL = dict(dataset="bair", channels=3, image_width=64, g_dim=90,
                   rnn_size=256, predictor_rnn_layers=2,
                   num_inducing_points=40, n_past=2, n_future=10, n_eval=30,
                   batch_size=50)
BAIR_TRAJ, BAIR_FRAMES, BAIR_PER_FILE = 100, 30, 4
# native against numpy decoder (tests/test_torch_data.py measured 2/255)
DECODER_ATOL = 2 / 255 + 1e-7

# [dist]: the parallel layer on one card (phase 14). The 2 × 2 tiny mesh's
# eval (a fork at step 15, 4 futures, 2 rows); the f64 gates of phase 11a
# for the 2-rank step and 1e-12 for the NCCL world-1 step against the same
# step without a group; the sharded f32 evals against one process; the
# bf16 sharded protocol's drift from one process held to CLI_TOL's bf16
# band (different batch sizes take different cuDNN kernels in bf16: the
# re-roll measured 2.4e-4 SSIM on DCGAN-64, PERF.md §6)
DIST_TINY_EVAL = dict(BB_TINY, nsample=4, batch_size=2)
DIST_TINY_SEED = 5
DIST_F64_TOL = 1e-9
DIST_NCCL_TOL = 1e-12
DIST_F32_TOL = dict(ssim_atol=1e-5, psnr_atol=1e-3, mse_rtol=1e-5)
DIST_BF16_TOL = dict(CLI_TOL["bfloat16"], mse_rtol=float("inf"))
# the --mesh 2 training CLI runs in bf16: each rank is a fresh process whose
# cuDNN autotuner (cudnn.benchmark, on in the CLI) spent 44 s on the f32
# step with TF32 off (NVIDIA H100 80GB HBM3, 700 W)
DIST_EPOCH = 5            # steps per epoch of the --mesh 2 training CLI
DIST_CLI_BATCHES = 1      # batches of the --mesh_samples 2 eval CLI
DIST_TIMEOUT_S = 600

# [serve] (phase 15): the artifacts' entries in the order they are loaded
# and timed; the cut depth of the f32 check (n_past 5: steps 5..19, a fork
# at 15), whose band is [dist]'s sharded-against-one-process one. Both sides
# run with cuDNN's autotuner off, so a fresh process takes the same kernels
# as the other: with it on, another kernel's last bf16 bit grew into
# another gp_trigger trajectory at unit gain. The bf16 bands hold the
# measured readings with margin (PERF.md §5: with the autotuner on,
# diverse_metrics within 3.4e-7 SSIM, 7.6e-6 dB and 1.7e-6 relative MSE
# of the live entry, posterior's frames 2.4e-4; with it off, gp_trigger's
# frames bit-equal): frames within one bf16 ulp in [0.5, 1)
SERVE_ENTRIES = ("diverse_metrics", "posterior", "gp_trigger")
SERVE_CUT = 20
SERVE_TRIGGER_SEED = 5
SERVE_F32_TOL = DIST_F32_TOL
SERVE_BF16_TOL = dict(ssim_atol=1e-5, psnr_atol=1e-3, mse_rtol=1e-5)
SERVE_BF16_FRAME_ATOL = 2.0 ** -8
SERVE_TIMEOUT_S = 600
SERVE_REPS = 3            # timed calls per entry and side
# phase 16: a trained checkpoint's kernels against plain, card against CPU
TRAINED_TOL = dict(ssim_atol=1e-4, psnr_atol=1e-3, mse_rtol=1e-5)
TRAINED_PROTOCOL = dict(nsample=100, batch_size=50)  # the eval CLI's
TRAINED_ROWS, TRAINED_S = 2, 4  # f32 posterior / diverse_metrics vs the CPU
TRAINED_TRIGGER_ROWS = 8  # f32 gp_trigger vs the CPU
# the f32 card-vs-CPU checks' depth: n_past 5 and 15 free steps, the
# recipe's training horizon (n_future 10) and the first fork (step 15). A
# trained model's free run carries f32 rounding further at every step: on
# runs/soak_smmnist_torch's weights the posterior's frames part 3.7e-5 at
# the first free step and 2.9e-4 at the 25th; at n_eval 30 the quick
# model's diverse_metrics MSE parted 9.6e-5 relative (NVIDIA H100 80GB
# HBM3, 700 W)
TRAINED_CUT = 20


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


def k1_cost(s_n: int, b: int, h: int, w: int, c: int, pred_bytes: int,
            win: int = 7):
    """(bytes, f32 operations) K1 must at least move and do for one launch
    scoring S·B pred images against B gt images: pred and gt (f32) each
    read once, three f32 per pred image written. Per pred plane: staging,
    sums and squared error (8 per pixel), running-sum 7-wide boxes of pc,
    pc², gc·pc in both directions (3 per output each) and the SSIM map (25
    per map pixel); per gt plane, once: its mean and centring (4 per pixel)
    and the boxes of gc, gc² (3 per output each). K2 is the case S = 1."""
    hp, wp = h - win + 1, w - win + 1
    n = s_n * b
    nbytes = n * h * w * c * pred_bytes + b * h * w * c * 4 + 3 * n * 4
    flops = (n * c * (8 * h * w + 9 * h * wp + 9 * hp * wp + 25 * hp * wp)
             + b * c * (4 * h * w + 6 * h * wp + 6 * hp * wp))
    return nbytes, flops


def events_ms(fn):
    """(fn's result, device ms of that one call by CUDA events)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_kernels(fn):
    """(the card's kernels of one fn() call under torch.profiler, their
    summed device ms, the ms from the first kernel's start to the last's
    end)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    return kernels, busy, span


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
    global CARD_LINE
    CARD_LINE = smi.stdout.strip().splitlines()[0]
    print(CARD_LINE)
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    print(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}  nvcc {nvcc[-1] if nvcc else '?'}")
    print(f"[env] device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    resources = {}
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        t0 = time.perf_counter()
        log = _build.build(name)
        print(f"[build] {name}: {time.perf_counter() - t0:.2f} s "
              f"({'compiled' if log else 'cached'})")
        entry = name
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                resources.setdefault(entry, []).append(
                    line.replace("ptxas info    :", "").strip())
    for entry, lines in resources.items():
        print(f"[build] {entry}: {'; '.join(lines)}")
    return resources


def spills(resources) -> list:
    """ptxas lines that report a spill, by kernel instance."""
    return [f"{entry}: {line}" for entry, lines in resources.items()
            for line in lines if re.search(r"\b[1-9]\d* bytes spill", line)]


def kernel_label(mangled: str) -> str:
    """'ssim_kernel bf16 C3 G2' etc. for a mangled ssim_kernel<T, C, G>
    instance (K1 runs the G2 instances, K2 the G1 instances); 'epilogue
    bf16 act 1 pre 1 vec 1' etc. for K3's instances, 'epilogue pool bf16
    act 1 vec 1' for its pooled form's."""
    m = re.search(r"dvg_elementwise_epilogueI(13__nv_bfloat16|f)Li(\d)ELb"
                  r"([01])ELb([01])E", mangled)
    if m is not None:
        return (f"epilogue {'f32' if m.group(1) == 'f' else 'bf16'} act "
                f"{m.group(2)} pre {m.group(3)} vec {m.group(4)}")
    m = re.search(r"dvg_elementwise_epilogue_poolI(13__nv_bfloat16|f)Li(\d)"
                  r"ELb([01])E", mangled)
    if m is not None:
        return (f"epilogue pool {'f32' if m.group(1) == 'f' else 'bf16'} "
                f"act {m.group(2)} vec {m.group(3)}")
    m = re.search(r"dvg_elementwise_bn_(stats|apply|bwd_sums|bwd)I"
                  r"(13__nv_bfloat16|f|d)(?:Li(\d)E)?Lb([01])E", mangled)
    if m is not None:
        dtype = {"f": "f32", "d": "f64"}.get(m.group(2), "bf16")
        act = f" act {m.group(3)}" if m.group(3) else ""
        return f"bn {m.group(1)} {dtype}{act} vec {m.group(4)}"
    m = re.search(r"ssim_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E", mangled)
    if m is None:
        return mangled
    dtype = "f32" if m.group(1) == "f" else "bf16"
    return f"ssim_kernel {dtype} C{m.group(2)} G{m.group(3)}"


def kernel_inputs(dev, s_n: int, b: int, side: int, c: int, seed: int):
    """gt (b, side, side, c) f32 and a correlated bf16 pred (s_n·b, ...)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    gt = torch.rand((b, side, side, c), generator=g, device=dev)
    pred = (0.6 * gt.repeat(s_n, 1, 1, 1)
            + 0.4 * torch.rand((s_n * b, side, side, c), generator=g,
                               device=dev)).to(torch.bfloat16)
    return gt, pred


def check_identical(tag: str, fn, gt) -> None:
    """Identical images (gt made bf16-representable): SSIM 1, MSE 0."""
    import torch
    same = gt.to(torch.bfloat16)
    s_v, q_v, m_v = fn(same.float(), same)
    torch.cuda.synchronize()
    d1 = (s_v - 1).abs().max().item()
    print(f"{tag} identical images: max|ssim-1| {d1:.3e}  max mse "
          f"{m_v.max().item():.3e}  min psnr {q_v.min().item():.1f} dB")
    check(d1 <= 1e-4 and m_v.max().item() == 0.0, f"{tag} identical images")


def phase_k1():
    """K1 against its plain version at the headline step shape (gt (50, H,
    H, 3) f32, pred (5000, H, H, 3) bf16) at H = 64 and 128, on identical
    images and with f32 pred; times the kernel, its wrapper and the plain
    version."""
    import torch
    from dvg_tpu_torch.ops import ssim as plain
    from dvg_tpu_torch.ops import ssim_cuda
    s_n, b, c = HEADLINE["nsample"], HEADLINE["batch_size"], 3
    result = None
    for side in SIDES:
        tag = f"[k1 {side}px]"
        gt, pred = kernel_inputs(torch.device(CARD), s_n, b, side, c, seed=0)
        got = ssim_cuda.ssim_psnr_batch_cyclic(gt, pred)
        torch.cuda.synchronize()
        errs = max_errs(got, plain.ssim_psnr_cyclic_plain(gt, pred))
        print(f"{tag} headline step {tuple(pred.shape)} bf16 vs plain: "
              f"max|dssim| {errs[0]:.3e}  max|dpsnr| {errs[1]:.3e} dB  "
              f"max rel dmse {errs[2]:.3e}  (tol {K1_TOL})")
        check(within(errs, K1_TOL), f"K1 {side}px disagrees with its plain "
              f"version: {errs}")
        check(all(torch.isfinite(t).all() for t in got), "K1 not finite")
        check_identical(tag, lambda g, p: ssim_cuda.ssim_psnr_batch_cyclic(
            g, p.repeat(4, 1, 1, 1)), gt)
        pred32 = pred[:4 * b].float()       # f32 pred, as the f32 path has it
        errs32 = max_errs(ssim_cuda.ssim_psnr_batch_cyclic(gt, pred32),
                          plain.ssim_psnr_cyclic_plain(gt, pred32))
        print(f"{tag} f32 pred vs plain: {errs32[:3]}")
        check(within(errs32, K1_TOL), f"K1 {side}px f32 pred: {errs32}")

        k_ms = cuda_ms(lambda: ssim_cuda.launch(gt, pred), 20)
        w_ms = cuda_ms(lambda: ssim_cuda.ssim_psnr_batch_cyclic(gt, pred), 20)
        p_ms = cuda_ms(lambda: plain.ssim_psnr_cyclic_plain(gt, pred), 5)
        nbytes, flops = k1_cost(s_n, b, side, side, c, pred.element_size())
        b_ms, b_by = bound(nbytes, flops)
        blocks, threads = ssim_cuda.occupancy(pred.dtype, c, side, side)
        print(f"{tag} kernel {k_ms * 1e3:.1f} us/launch (G "
              f"{ssim_cuda.GROUP}; {blocks} resident blocks/SM x {threads} "
              f"threads)  wrapper "
              f"{w_ms * 1e3:.1f} us (wrapper - kernel "
              f"{(w_ms - k_ms) * 1e3:.1f} us)  plain {p_ms * 1e3:.1f} us  "
              f"bound {b_ms * 1e3:.1f} us by {b_by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)  = {b_ms / k_ms:.1%} of bound")
        if result is None:                  # the main path's shape
            result = dict(max_abs_err=errs[3], ms=k_ms, plain_ms=p_ms,
                          bound_ms=b_ms, bound_by=b_by)
        del gt, pred, pred32
        torch.cuda.empty_cache()
    return result


def phase_k2(resources):
    """K2 against its plain version: K2_IMAGES one-to-one pairs of H×H×3
    at H = 64 and 128, f32 gt, pred bf16 and f32; identical images; times
    the kernel, its wrapper and the plain version."""
    import torch
    from dvg_tpu_torch.ops import ssim as plain
    from dvg_tpu_torch.ops import ssim_cuda
    n, c = K2_IMAGES, 3
    result = None
    for side in SIDES:
        tag = f"[k2 {side}px]"
        gt, pred = kernel_inputs(torch.device(CARD), 1, n, side, c, seed=5)
        worst = 0.0
        for name, p in (("bf16", pred), ("f32", pred.float())):
            got = ssim_cuda.ssim_psnr_batch_images(gt, p)
            torch.cuda.synchronize()
            errs = max_errs(got, plain.ssim_psnr_images_plain(gt, p))
            print(f"{tag} {n} pairs {tuple(p.shape)} {name} pred vs plain: "
                  f"max|dssim| {errs[0]:.3e}  max|dpsnr| {errs[1]:.3e} dB  "
                  f"max rel dmse {errs[2]:.3e}  (tol {K1_TOL})")
            check(within(errs, K1_TOL),
                  f"K2 {side}px ({name} pred) disagrees: {errs}")
            check(all(torch.isfinite(t).all() for t in got), "K2 not finite")
            worst = max(worst, errs[3])
        check_identical(tag, ssim_cuda.ssim_psnr_batch_images, gt[:64])

        k_ms = cuda_ms(lambda: ssim_cuda.launch_images(gt, pred), 20)
        w_ms = cuda_ms(lambda: ssim_cuda.ssim_psnr_batch_images(gt, pred), 20)
        p_ms = cuda_ms(lambda: plain.ssim_psnr_images_plain(gt, pred), 5)
        nbytes, flops = k1_cost(1, n, side, side, c, pred.element_size())
        b_ms, b_by = bound(nbytes, flops)
        blocks, threads = ssim_cuda.occupancy(pred.dtype, c, side, side,
                                              images=True)
        print(f"{tag} kernel {k_ms * 1e3:.1f} us/launch (G 1, one-to-one; "
              f"{blocks} resident blocks/SM x {threads} threads)  wrapper "
              f"{w_ms * 1e3:.1f} us  plain {p_ms * 1e3:.1f} us  bound "
              f"{b_ms * 1e3:.1f} us by {b_by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)  = {b_ms / k_ms:.1%} of bound")
        if result is None:
            result = dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                          bound_ms=b_ms, bound_by=b_by)
        del gt, pred
        torch.cuda.empty_cache()
    for entry in ("ssim_kernel bf16 C3 G1", "ssim_kernel f32 C3 G1"):
        print(f"[k2] ptxas {entry}: {'; '.join(resources.get(entry, ['?']))}")
    return result


def phase_k3(resources):
    """K3 (the conv epilogue) against its plain version at the VGG-128
    eval's largest map, (800, 64, 128, 128) bf16 channels_last, with and
    without the skip half, and at its 3-channel final conv, for every
    activation; times the kernel beside its HBM bound (y and pre read once,
    out written once), the plain version and the stock chain the eval path
    ran before it (cuDNN's bias add_ and leaky_relu; with the skip half,
    the adds and leaky_relu) as a yardstick only."""
    import torch
    import torch.nn.functional as F
    from dvg_tpu_torch.ops import epilogue as E
    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(3)
    result, worst = None, 0.0
    for shape in ((800, 64, 128, 128), (800, 3, 128, 128)):
        tag = f"[k3 {shape[1]}ch]"
        y, pre = (torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
            for _ in range(2))
        bias = torch.randn(shape[1], generator=g, device=dev).to(
            torch.bfloat16)
        for p in (None, pre):
            for act in E.ACTS:
                got = E.conv_epilogue(y, bias, p, act)
                ref = E.conv_epilogue_plain(y, bias, p, act)
                d = (got.float() - ref.float()).abs()
                ulp = (d / (2.0 ** -7 * ref.float().abs()).clamp(
                    min=1e-38)).max().item()
                exact = torch.equal(got, ref)
                err = d.max().item()
                worst = max(worst, err)
                del got, ref, d
                print(f"{tag} {tuple(shape)} bf16 pre {p is not None} "
                      f"{act}: bitwise {exact}, max|d| {err:.3e}, worst "
                      f"{ulp:.2f} of 2^-7 relative")
                check(exact if act in ("none", "leaky_relu") else ulp <= 1,
                      f"K3 {shape} {act} disagrees with its plain version")
            act = "leaky_relu" if shape[1] > 3 else "sigmoid"
            k_ms = cuda_ms(lambda: E.launch(y, bias, p, act, 1), 20)
            w_ms = cuda_ms(lambda: E.conv_epilogue(y, bias, p, act), 20)
            p_ms = cuda_ms(lambda: E.conv_epilogue_plain(y, bias, p, act), 3)
            b3 = bias[:, None, None]
            if p is None:               # y is spent: it is remade below
                stock = (lambda: E.activate(y.add_(b3), act))
            else:
                stock = (lambda: E.activate(y + p + b3, act))
            s_ms = cuda_ms(stock, 10)
            nbytes = y.numel() * y.element_size() * (2 if p is None else 3)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"{tag} pre {p is not None} {act}: kernel "
                  f"{k_ms * 1e3:.1f} us/launch  wrapper {w_ms * 1e3:.1f} us  "
                  f"plain {p_ms * 1e3:.1f} us  stock chain "
                  f"{s_ms * 1e3:.1f} us  bound {b_ms * 1e3:.1f} us by bytes "
                  f"({nbytes / 1e9:.2f} GB)  = {b_ms / k_ms:.1%} of bound")
            if result is None:
                result = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                              bound_by="bytes")
            y = torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
        del y, pre
        torch.cuda.empty_cache()
    pool = phase_k3_pool(g)
    for entry, lines in resources.items():
        if "epilogue" in entry:
            print(f"[k3] ptxas {entry}: {'; '.join(lines)}")
    return dict(result, max_abs_err=worst, pool=pool)


def phase_k3_pool(g) -> dict:
    """K3's pooled form at POOL_SHAPE bf16 channels_last against its plain
    version (bitwise for none and leaky_relu, tanh and sigmoid within 1
    bf16 ulp) and against max_pool2d of the plain epilogue; times the
    kernel beside its byte bound (y read once, the pooled map written
    once), its wrapper, the plain version and the K3 + max_pool2d pair it
    replaces."""
    import torch
    import torch.nn.functional as F
    from dvg_tpu_torch.ops import epilogue as E
    tag = "[k3 pool]"
    dev = torch.device(CARD)
    y = torch.randn(POOL_SHAPE, generator=g, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bias = torch.randn(POOL_SHAPE[1], generator=g, device=dev).to(
        torch.bfloat16)
    for act in E.ACTS:
        got = E.conv_epilogue_pool(y, bias, act)
        ref = E.conv_epilogue_pool_plain(y, bias, act)
        stock = F.max_pool2d(E.conv_epilogue_plain(y, bias, None, act), 2, 2)
        d = (got.float() - ref.float()).abs()
        ulp = (d / (2.0 ** -7 * ref.float().abs()).clamp(
            min=1e-38)).max().item()
        exact = torch.equal(got, ref)
        print(f"{tag} {POOL_SHAPE} -> {tuple(got.shape)} bf16 {act}: "
              f"bitwise {exact} (max_pool2d of plain: "
              f"{torch.equal(got, stock)}), max|d| {d.max().item():.3e}, "
              f"worst {ulp:.2f} of 2^-7 relative; channels_last "
              f"{got.is_contiguous(memory_format=torch.channels_last)}")
        check(got.is_contiguous(memory_format=torch.channels_last),
              "the pooled form's output is not channels_last")
        if act in ("none", "leaky_relu"):
            check(exact and torch.equal(got, stock),
                  f"K3's pooled form {act} is not bitwise its plain version")
        else:
            check(ulp <= 1, f"K3's pooled form {act} disagrees with plain")
        del got, ref, stock, d
    act = "leaky_relu"
    k_ms = cuda_ms(lambda: E.launch_pool(y, bias, act), 20)
    w_ms = cuda_ms(lambda: E.conv_epilogue_pool(y, bias, act), 20)
    p_ms = cuda_ms(lambda: E.conv_epilogue_pool_plain(y, bias, act), 3)
    pair_ms = cuda_ms(lambda: F.max_pool2d(E.launch(y, bias, None, act, 1),
                                           2, 2), 20)
    nbytes = y.numel() * y.element_size() * 5 // 4
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{tag} {act}: kernel {k_ms * 1e3:.1f} us/launch  wrapper "
          f"{w_ms * 1e3:.1f} us  plain {p_ms * 1e3:.1f} us  K3 + max_pool2d "
          f"{pair_ms * 1e3:.1f} us  bound {b_ms * 1e3:.1f} us by bytes "
          f"({nbytes / 1e9:.2f} GB)  = {b_ms / k_ms:.1%} of bound")
    del y
    torch.cuda.empty_cache()
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, pair_ms=pair_ms)


def phase_resample() -> dict:
    """The five folded up halves of VGG-128's decoder at the eval cell's
    800 frames, bf16 channels_last: each stride-2 transposed conv of the
    small map against the nearest ×2 upsample + 3×3 conv it replaces,
    timed after cuDNN's autotuning, with the output's layout and the
    largest difference between the two."""
    import torch
    import torch.nn.functional as F
    from dvg_tpu_torch.models import layers as L
    from dvg_tpu_torch.models import vgg
    torch.backends.cudnn.benchmark = True
    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(11)
    cl = torch.channels_last
    out = {}
    for i, chain in enumerate(vgg.dec_groups(128)):
        c_u, c_o, side = chain[0] // 2, chain[1], 4 * 2 ** i
        w = torch.randn((c_o, c_u, 3, 3), generator=g, device=dev) * (
            2.0 / (9 * c_u)) ** 0.5
        wf = vgg.fold_upsample(w).to(torch.bfloat16).contiguous(
            memory_format=cl)
        w = w.to(torch.bfloat16).contiguous(memory_format=cl)
        d = torch.rand((POOL_SHAPE[0], c_u, side, side), generator=g,
                       device=dev).to(torch.bfloat16).contiguous(
                           memory_format=cl)
        fold = lambda: F.conv_transpose2d(d, wf, None, 2, 1)   # noqa: E731
        old = lambda: F.conv2d(L.upsample_nearest2d(d), w, None, 1, 1)  # noqa
        y = fold()
        diff = (y.float() - old().float()).abs().max().item()
        f_ms, o_ms = cuda_ms(fold, 20), cuda_ms(old, 20)
        layout = y.is_contiguous(memory_format=cl)
        print(f"[resample] group {i} ({c_u} -> {c_o}, {side} -> {2 * side} "
              f"px): folded transposed conv {f_ms * 1e3:.1f} us, upsample + "
              f"conv {o_ms * 1e3:.1f} us ({o_ms / f_ms:.2f}x); channels_last "
              f"{layout}; max|d| {diff:.3e}")
        check(layout, f"group {i}'s folded up half is not channels_last")
        out[i] = dict(fold_ms=f_ms, old_ms=o_ms)
        del d, y, w, wf
    torch.cuda.empty_cache()
    f_all = sum(r["fold_ms"] for r in out.values())
    o_all = sum(r["old_ms"] for r in out.values())
    print(f"[resample] five up halves: folded {f_all * 1e3:.1f} us, upsample "
          f"+ conv {o_all * 1e3:.1f} us a free step ({CARD_LINE})")
    return out


def _k4_rel(got, want) -> float:
    """max |got − want| over max |want|."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def phase_k4(resources) -> dict:
    """K4 (csrc/bn_act.cu, train-mode BatchNorm and its activation) at
    K4_SHAPES in bf16 and f32: its statistics against the plain chain's
    (rtol 1e-5), the apply bitwise given the plain statistics (tanh within
    a bf16 ulp), the backward against the plain formula on its own
    statistics; each kernel timed beside its byte bound (each map read or
    written once: stats reads y, apply y and out, the sums y and g, dy y,
    g and dy; tanh reads out too), the forward and forward + backward of
    the operator, of the plain chain and, as a yardstick only,
    F.batch_norm(training=True) + the activation over the whole map. Then
    the train cell's step (K4_STEP): K4's launches in one step
    (K4_PER_STEP), ms a step by events, peak memory, device time by group
    and K4's device launches in one profiled step."""
    import torch
    import torch.nn.functional as F
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.ops import batchnorm as BN
    from dvg_tpu_torch.train import init_train_state, make_train_step
    dev = torch.device(CARD)
    cl = torch.channels_last
    g = torch.Generator(device=dev).manual_seed(19)
    result = None
    for shape, calls in K4_SHAPES:
        act = "tanh" if shape[1] == 90 else "leaky_relu"
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"[k4 {shape[1]}ch {str(dtype)[6:]}]"
            y = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(
                dtype).contiguous(memory_format=cl)
            w = (1 + 0.3 * torch.randn(shape[1], generator=g,
                                       device=dev)).to(dtype)
            b = (0.2 * torch.randn(shape[1], generator=g,
                                   device=dev)).to(dtype)
            gr = torch.randn(shape, generator=g, device=dev).to(
                dtype).contiguous(memory_format=cl)
            plain_out, plain = BN.bn_plain(y, w, b, calls)
            plain_out = BN.activate(plain_out, act)
            stats = BN.launch_stats(y, w, calls)
            s_err = max(_k4_rel(stats[i], plain[i]) for i in range(4))
            got = BN.launch_apply(y, plain[0].contiguous(),
                                  plain[2].contiguous(), b, calls, act)
            exact = torch.equal(got, plain_out)
            a_err = (got.double() - plain_out.double()).abs().max().item()
            ulp = ((got.double() - plain_out.double()).abs()
                   / (2.0 ** -7 * plain_out.double().abs()).clamp(
                       min=1e-38)).max().item()
            out = BN.launch_apply(y, stats[0], stats[2], b, calls, act)
            o = out if act == "tanh" else None
            sums, dg, db = BN.launch_bwd_sums(gr, y, o, stats, b, calls, act)
            dy = BN.launch_bwd(gr, y, o, stats, b, sums, calls, act)
            want = BN.bn_act_backward_plain(gr, y, o, stats, b, calls, act)
            g_err = max(_k4_rel(k, r) for k, r in zip((dy, dg, db), want))
            torch.cuda.synchronize()
            print(f"{tag} {tuple(shape)} in {calls} calls, {act}: stats max "
                  f"rel {s_err:.2e}; apply given the plain stats bitwise "
                  f"{exact} (max|d| {a_err:.2e}, {ulp:.2f} of 2^-7 "
                  f"relative); dy, dgamma, dbeta max rel {g_err:.2e}")
            g_tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
            check(s_err <= 1e-5, f"K4 statistics {shape} {dtype}: {s_err}")
            check(exact if act == "leaky_relu" else ulp <= 1,
                  f"K4 apply {shape} {dtype} disagrees with plain")
            check(g_err <= g_tol, f"K4 backward {shape} {dtype}: {g_err}")
            del plain_out, plain, got, want

            ms = dict(
                stats=cuda_ms(lambda: BN.launch_stats(y, w, calls), 20),
                apply=cuda_ms(lambda: BN.launch_apply(
                    y, stats[0], stats[2], b, calls, act), 20),
                sums=cuda_ms(lambda: BN.launch_bwd_sums(
                    gr, y, o, stats, b, calls, act), 20),
                dy=cuda_ms(lambda: BN.launch_bwd(
                    gr, y, o, stats, b, sums, calls, act), 20))
            n = y.numel() * y.element_size()
            t = int(act == "tanh")
            nbytes = dict(stats=n, apply=2 * n, sums=(2 + t) * n,
                          dy=(3 + t) * n)
            for k in ms:
                b_ms = nbytes[k] / HBM_BYTES_PER_S * 1e3
                print(f"{tag} {k}: {ms[k] * 1e3:.1f} us/launch  bound "
                      f"{b_ms * 1e3:.1f} us by bytes ({nbytes[k] / 1e9:.3f} "
                      f"GB)  = {b_ms / ms[k]:.1%} of bound")
            yl, wl, bl = (v.detach().requires_grad_() for v in (y, w, b))
            lw, lb = ((wl, bl) if dtype == torch.float32 else
                      (wl.float().detach().requires_grad_(),
                       bl.float().detach().requires_grad_()))

            def fwd_bwd(fn, leaves):
                return lambda: torch.autograd.grad(fn(), leaves, gr)

            def k4():
                return BN.bn_act(yl, wl, bl, calls, act)[0]

            def stock():
                return BN.bn_act_plain(yl, wl, bl, calls, act)[0]

            def library():
                return BN.activate(F.batch_norm(yl, None, None, lw, lb,
                                                training=True), act)
            with torch.no_grad():
                f_ms = [cuda_ms(fn, reps) for fn, reps in
                        ((k4, 20), (stock, 3), (library, 20))]
            fb_ms = [cuda_ms(fwd_bwd(fn, leaves), reps) for fn, leaves, reps
                     in ((k4, (yl, wl, bl), 10), (stock, (yl, wl, bl), 3),
                         (library, (yl, lw, lb), 10))]
            fwd_bound = (nbytes["stats"] + nbytes["apply"]) / HBM_BYTES_PER_S
            bwd_bound = (nbytes["sums"] + nbytes["dy"]) / HBM_BYTES_PER_S
            print(f"{tag} forward: K4 {f_ms[0] * 1e3:.1f} us (bound "
                  f"{fwd_bound * 1e6:.1f}), plain {f_ms[1] * 1e3:.1f} us, "
                  f"F.batch_norm + act {f_ms[2] * 1e3:.1f} us; forward + "
                  f"backward: K4 {fb_ms[0] * 1e3:.1f} us (bound "
                  f"{(fwd_bound + bwd_bound) * 1e6:.1f}), plain "
                  f"{fb_ms[1] * 1e3:.1f} us, F.batch_norm + act "
                  f"{fb_ms[2] * 1e3:.1f} us")
            if result is None:
                result = dict(ms=f_ms[0], plain_ms=f_ms[1],
                              bound_ms=fwd_bound * 1e3, bound_by="bytes",
                              library_ms=f_ms[2], max_abs_err=g_err,
                              passes={k: (ms[k], nbytes[k] / HBM_BYTES_PER_S
                                          * 1e3) for k in ms})
            del y, gr, yl, stats, out, sums, dy
            torch.cuda.empty_cache()
    for entry, lines in resources.items():
        if entry.startswith("bn "):
            print(f"[k4] ptxas {entry}: {'; '.join(lines)}")

    torch.backends.cudnn.benchmark = True
    cfg = DVGConfig(**K4_STEP)
    state = init_train_state(cfg, device=CARD)
    step = make_train_step(cfg)
    x = torch.rand((cfg.seq_len_train, cfg.batch_size, 64, 64, 1),
                   generator=g, device=dev)
    step(state, x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = BN.bn_act.launches
    step(state, x)
    torch.cuda.synchronize()
    launches = BN.bn_act.launches - before
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(K4_STEPS):
        step(state, x)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / K4_STEPS
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / K4_STEPS
    peak = torch.cuda.max_memory_allocated() / 1e9
    kernels, busy, span = device_kernels(lambda: step(state, x))
    traced = sum("dvg_elementwise_bn" in e.name for e in kernels)
    print(f"[k4 step] DCGAN-64 C 1 B {cfg.batch_size} bf16 ft: K4 launches "
          f"{launches} a step (traced {traced}); {step_ms:.2f} ms/step by "
          f"events over {K4_STEPS} steps ({cfg.batch_size * 1e3 / step_ms:.1f}"
          f" clips/s; the host issues a step in {host_ms:.2f} ms); peak {peak:.2f} GB; profiled step: {len(kernels)} "
          f"kernels, device busy {busy:.1f} ms of a {span:.1f} ms span "
          f"({CARD_LINE})")
    print_kernel_groups("[k4 step]", kernels, busy, TRAIN_GROUPS)
    check(launches == traced == K4_PER_STEP,
          f"K4 launched {launches} times a step ({traced} traced), not "
          f"{K4_PER_STEP}")
    del state, step, x
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    return dict(result, launches=launches, step_ms=step_ms)


def k3_per_call(cfg) -> int:
    """K3's launches in one diverse_metrics call of `cfg`'s folded model:
    one per conv of the context's encode, then of one encode and one
    decode per free step (each pass runs K3_PER_PASS convs: the encoder's
    blocks and head, or the decoder's head, blocks and final conv)."""
    per_pass = K3_PER_PASS[cfg.model, cfg.image_width]
    return per_pass * (1 + 2 * (cfg.n_eval - cfg.n_past))


def pool_per_call(cfg) -> int:
    """Of them, the launches of K3's pooled form: every free step's encode
    ends each VGG group in it unless the skips refresh."""
    if cfg.last_frame_skip:
        return 0
    return (POOL_PER_ENCODE.get((cfg.model, cfg.image_width), 0)
            * (cfg.n_eval - cfg.n_past))


def phase_checkpoint(directory: str) -> str:
    """The headline model from seeded weights, written in the dvg_tpu
    format and read back; every leaf must come back equal."""
    import os
    import torch
    from dvg_tpu_torch.checkpoint import load_model, save_checkpoint
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.models.dvg import DVGModel
    cfg = DVGConfig(**HEADLINE)
    model = DVGModel(cfg, seed=0, device=CARD)
    t0 = time.perf_counter()
    path = save_checkpoint(directory, cfg, model)
    write_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cfg2, loaded = load_model(path, device=CARD)
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    want, got = model.state_dict(), loaded.state_dict()
    same = want.keys() == got.keys() and all(
        torch.equal(want[k], got[k]) for k in want)
    print(f"[ckpt] DCGAN-64 headline model: {os.path.getsize(path) / 1e6:.1f}"
          f" MB, {len(want)} leaves; write {write_ms:.0f} ms, read onto the "
          f"card {read_ms:.0f} ms; config equal {cfg2 == cfg}, every leaf "
          f"equal {same}")
    check(cfg2 == cfg, "the checkpoint's config differs")
    check(same, "a checkpoint leaf came back different")
    return path


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
    for dev in ("cpu", CARD):
        model = unit_gain_model(cfg, dev)
        ssim_psnr_batch_cyclic.launches = 0
        out = make_rollout_fns(model, cfg).diverse_metrics(x, noise=noise,
                                                           device=dev)
        if dev == CARD:
            torch.cuda.synchronize()
            launches = ssim_psnr_batch_cyclic.launches
        outs[dev] = {k: v.cpu() for k, v in out.items()}
    cpu, card = outs["cpu"], outs[CARD]
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


def with_trained_gp(model, seed: int):
    """Give `model` (on the CPU) a trained-looking GP, in place: spread
    inducing points, a non-zero variational mean, a non-identity
    variational Cholesky, a shorter lengthscale and a smaller noise. At the
    init's L_S = I the GP variance is the constant outputscale, so the
    trigger's signal would never move; the spread keeps K_ZZ well
    conditioned, so the card's f32 GP cache and the CPU's agree."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    d, m = model.gp.var_mean.shape
    values = dict(
        z=np.linspace(-1, 1, m)[None, :, None]
        + rng.uniform(-0.03, 0.03, (d, m, 1)),
        var_mean=rng.normal(0, 0.5, (d, m)),
        var_chol=np.eye(m) * rng.uniform(0.2, 0.6, (d, 1, m))
        + np.tril(rng.normal(0, 0.1, (d, m, m)), -1),
        raw_lengthscale=np.full(d, -1.2))
    with torch.no_grad():
        for name, v in values.items():
            getattr(model.gp, name).copy_(torch.as_tensor(v,
                                                          dtype=torch.float32))
        model.likelihood.raw_noise.fill_(-2.0)
    return model


METRICS = ("ssim", "psnr", "mse")


def frames_err(a, b) -> float:
    return (a.cpu() - b.cpu()).abs().max().item()


def phase_gen_tiny():
    """The rest of generation on the tiny f32 config, card against CPU,
    with the seeded noise; then the exact re-roll on the card."""
    import numpy as np
    import torch
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    from dvg_tpu_torch.ops import ssim_cuda
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DVGConfig(**TINY)
    n_past, n_free = cfg.n_past, cfg.n_eval - cfg.n_past
    x = (np.random.RandomState(1).rand(cfg.n_eval, cfg.batch_size, 64, 64, 3)
         * 2 - 1).astype(np.float32)
    models = {"cpu": with_trained_gp(unit_gain_model(cfg, "cpu"), seed=2)}
    models[CARD] = copy.deepcopy(models["cpu"]).to(CARD)
    devs = ("cpu", CARD)

    def fns(dev, **kw):
        return make_rollout_fns(models[dev], cfg.replace(**kw))

    post = {d: fns(d).posterior(x, device=d).cpu() for d in devs}
    err = frames_err(post[CARD], post["cpu"])
    print(f"[gen-tiny] posterior {tuple(post[CARD].shape)} card vs cpu: "
          f"max|dframe| {err:.3e} (atol {FRAME_ATOL})")
    check(err <= FRAME_ATOL and bool(torch.isfinite(post[CARD]).all()),
          f"posterior card vs CPU: {err}")

    # the margin, among those at which some but not all decisions fire,
    # whose nearest decision sits farthest from its threshold (on the CPU)
    best = None
    for margin in (0.0, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3):
        _, diag = fns("cpu", trigger_margin=margin).gp_trigger(
            x, seed=7, device="cpu")
        gap = (diag["values"] - diag["thresholds"]).abs().min().item()
        if diag["triggers"].any() and not diag["triggers"].all() and (
                best is None or gap > best[1]):
            best = (margin, gap)
    check(best is not None, "no trigger margin fires on some but not all "
          "decisions of the tiny clip")
    runs = {d: fns(d, trigger_margin=best[0]).gp_trigger(x, seed=7, device=d)
            for d in devs}
    f_cpu, d_cpu = runs["cpu"]
    f_card, d_card = runs[CARD][0], {k: v.cpu() for k, v in runs[CARD][1].items()}
    masks_equal = torch.equal(d_card["triggers"], d_cpu["triggers"])
    ferr = frames_err(f_card, f_cpu)
    verr = max(((d_card[k] - d_cpu[k]).abs() / d_cpu[k].abs()).max().item()
               for k in ("values", "warmup_values"))
    margin_cpu = d_cpu["values"] - d_cpu["thresholds"]
    derr = (d_card["values"] - d_card["thresholds"] - margin_cpu
            ).abs().max().item()
    gap = margin_cpu.abs().min().item()
    trig = d_cpu["triggers"]
    print(f"[gen-tiny] gp_trigger margin {best[0]}: {int(trig.sum())} of "
          f"{trig.numel()} decisions fire, masks equal {masks_equal}; "
          f"max|dframe| {ferr:.3e}, values max rel d {verr:.3e}; nearest "
          f"decision {gap:.3e} from its threshold = "
          f"{gap / max(derr, 1e-30):.3g}x the card-vs-cpu difference "
          f"{derr:.3e} of value - threshold")
    check(masks_equal, "gp_trigger masks differ between card and CPU")
    check(ferr <= FRAME_ATOL, f"gp_trigger frames card vs CPU: {ferr}")
    check(verr <= 1e-4, f"gp_trigger values card vs CPU: {verr}")
    check(gap >= 10 * derr, f"a trigger decision sits {gap} from its "
          f"threshold, within 10x the card-vs-CPU difference {derr}")

    met = {d: {k: v.cpu() for k, v in fns(d).diverse_metrics(
        x, seed=11, device=d).items()} for d in devs}
    errs = max_errs([met[CARD][k] for k in METRICS],
                    [met["cpu"][k] for k in METRICS])
    print(f"[gen-tiny] diverse_metrics(seed) card vs cpu: max|dssim| "
          f"{errs[0]:.3e}  max|dpsnr| {errs[1]:.3e} dB  max rel dmse "
          f"{errs[2]:.3e}  (tol {PATH_TOL})")
    check(within(errs, PATH_TOL), f"seeded diverse_metrics card vs CPU: "
          f"{errs}")

    # the exact re-roll: pairs whose futures forked at steps 15 and 30
    pairs = [(2, 1), (0, 0), (1, 1), (2, 0)]            # (sample, row)
    ids, rows = [p[0] for p in pairs], [p[1] for p in pairs]
    frames = fns(CARD).diverse_select_pairs(x[:, rows], ids, rows, seed=11,
                                            device=CARD)
    gt = torch.as_tensor(x[n_past:, rows], device=CARD).reshape(-1, 64, 64, 3)
    scored = ssim_cuda.ssim_psnr_batch_images(
        gt, frames[n_past:].reshape(-1, 64, 64, 3).contiguous())
    scored = [v.reshape(n_free, len(pairs)).cpu() for v in scored]
    ref = [torch.stack([met[CARD][k][s, :, r] for s, r in pairs], dim=1)
           for k in METRICS]
    errs = max_errs(scored, ref)
    spread = np.ptp(met[CARD]["mse"][:, 13].numpy(), axis=0).min()
    print(f"[gen-tiny] re-roll of {len(pairs)} (sample, row) pairs scored by "
          f"K2 vs their in-loop K1 scores: max|dssim| {errs[0]:.3e}  "
          f"max|dpsnr| {errs[1]:.3e} dB  max rel dmse {errs[2]:.3e}  (tol "
          f"{REROLL_TOL}); samples' mse spread at the step-15 fork "
          f"{spread:.3e}")
    check(within(errs, REROLL_TOL), f"the re-roll does not reproduce the "
          f"scored futures: {errs}")
    check(spread > 0, "the fork did not separate the samples")


def phase_main(ckpt: str):
    """The main path at full width, bf16, on the checkpoint's weights."""
    import torch
    from dvg_tpu_torch.checkpoint import load_model
    from dvg_tpu_torch.generate.rollout import best_of_n, make_rollout_fns
    from dvg_tpu_torch.ops.epilogue import conv_epilogue
    from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                             ssim_psnr_batch_images)
    torch.backends.cudnn.benchmark = True
    dev = torch.device(CARD)
    t0 = time.perf_counter()
    cfg, model = load_model(ckpt, device=CARD)
    s_n, b, n_free = cfg.nsample, cfg.batch_size, cfg.n_eval - cfg.n_past
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
    ssim_psnr_batch_images.launches = 0
    conv_epilogue.launches = 0
    t0 = time.perf_counter()
    start.record()
    out = fns.diverse_metrics(x, seed=MAIN_SEED)
    end.record()
    torch.cuda.synchronize()
    launches = ssim_psnr_batch_cyclic.launches
    k3 = conv_epilogue.launches
    host_s = time.perf_counter() - t0
    ms = start.elapsed_time(end)
    frames = s_n * n_free * b
    finite = all(torch.isfinite(v).all().item() for v in out.values())
    print(f"[main] DCGAN-64 bf16 S {s_n} B {b} n_free {n_free}: "
          f"{ms:.1f} ms/protocol (events; {MAIN_MS_BEFORE} ms with the "
          f"per-plane kernels, PERF.md §5), {host_s * 1e3:.1f} ms host, "
          f"{frames / (ms / 1e3):,.0f} frames/s; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"K1 launches {launches}; K3 launches {k3}; finite {finite}")
    for k, v in out.items():
        check(tuple(v.shape) == (s_n, n_free, b), f"{k} shape {v.shape}")
    check(finite, "non-finite metric in the main path")
    check(launches == n_free, f"K1 launched {launches} times, not {n_free}")
    check(k3 == k3_per_call(cfg),
          f"K3 launched {k3} times, not {k3_per_call(cfg)}")
    idx, best = best_of_n(out["ssim"].permute(2, 0, 1))
    check(bool(((idx >= 0) & (idx < s_n)).all()), "best-of-N index range")
    print(f"[main] mean ssim {out['ssim'].mean().item():.5f}  mean psnr "
          f"{out['psnr'].mean().item():.4f} dB  mean mse "
          f"{out['mse'].mean().item():.5f}  best-of-N mean ssim "
          f"{best.mean().item():.5f}")
    return cfg, fns, x, out, launches, k3


def phase_gen_full(cfg, fns, x, out):
    """The rest of generation at the headline width (bf16, the
    checkpoint's weights), each entry timed by CUDA events after a warm-up:
    posterior, gp_trigger, and the eval CLI's re-roll of the main run's
    best and 3 random futures of GIF_ROWS rows, scored by K2 — the K2 path,
    with every count set to 0 just before it and read just after."""
    import numpy as np
    import torch
    from dvg_tpu_torch.generate.rollout import TRIGGER_WARMUP, best_of_n
    from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                             ssim_psnr_batch_images)
    s_n, b, n_past, n_eval = cfg.nsample, cfg.batch_size, cfg.n_past, \
        cfg.n_eval
    n_free, img = n_eval - n_past, tuple(x.shape[2:])

    fns.posterior(x)                                      # warm-up
    post, post_ms = events_ms(lambda: fns.posterior(x))
    print(f"[gen-full] posterior B {b} n_eval {n_eval}: {post_ms:.1f} ms")
    check(tuple(post.shape) == (n_eval, b) + img
          and bool(torch.isfinite(post).all()), "posterior shape or finite")

    fns.gp_trigger(x, seed=5)                             # warm-up
    (frames, diag), trig_ms = events_ms(lambda: fns.gp_trigger(x, seed=5))
    per_row = diag["triggers"].sum(0).float()
    print(f"[gen-full] gp_trigger B {b} n_eval {n_eval}: {trig_ms:.1f} ms; "
          f"triggers per row min {per_row.min().item():.0f} mean "
          f"{per_row.mean().item():.2f} max {per_row.max().item():.0f} of "
          f"{n_eval - TRIGGER_WARMUP} steps")
    check(tuple(frames.shape) == (n_eval, b) + img
          and bool(torch.isfinite(frames).all())
          and tuple(diag["triggers"].shape) == (n_eval - TRIGGER_WARMUP, b),
          "gp_trigger shape or finite")

    idx, _ = best_of_n(out["ssim"].permute(2, 0, 1))
    rng = np.random.RandomState(0)
    sids, rows = [], []
    for i in range(min(b, GIF_ROWS)):
        sids += [int(idx[i])] + [int(v) for v in rng.randint(0, s_n, 3)]
        rows += [i] * 4
    x_sel = x[:, rows].contiguous()
    fns.diverse_select_pairs(x_sel, sids, rows, seed=MAIN_SEED)   # warm-up
    ssim_psnr_batch_cyclic.launches = 0
    ssim_psnr_batch_images.launches = 0
    sel, sel_ms = events_ms(
        lambda: fns.diverse_select_pairs(x_sel, sids, rows, seed=MAIN_SEED))
    scored, k2_ms = events_ms(lambda: ssim_psnr_batch_images(
        x_sel[n_past:].reshape((-1,) + img),
        sel[n_past:].reshape((-1,) + img)))
    launches = ssim_psnr_batch_images.launches
    k = len(sids)
    scored = [v.reshape(n_free, k) for v in scored]
    ref = [out[m][torch.tensor(sids), :, torch.tensor(rows)].T
           for m in METRICS]
    errs = max_errs(scored, ref)
    print(f"[gen-full] diverse_select_pairs of {k} pairs ({k // 4} rows x "
          f"[best + 3 random]): {sel_ms:.1f} ms; K2 scoring {k2_ms:.2f} ms, "
          f"K2 launches {launches}; K2 scores vs the same futures' K1 scores "
          f"in the main run (bf16, information only): max|dssim| "
          f"{errs[0]:.3e}  max|dpsnr| {errs[1]:.3e} dB  max rel dmse "
          f"{errs[2]:.3e}")
    check(tuple(sel.shape) == (n_eval, k) + img
          and bool(torch.isfinite(sel).all()), "re-roll shape or finite")
    check(all(bool(torch.isfinite(v).all()) for v in scored),
          "K2 scores not finite")
    check(launches == 1, f"K2 launched {launches} times for 1 call")
    check(ssim_psnr_batch_cyclic.launches == 0, "the re-roll launched K1")

    for name, fn in (("posterior", lambda: fns.posterior(x)),
                     ("gp_trigger", lambda: fns.gp_trigger(x, seed=5)),
                     ("re-roll", lambda: fns.diverse_select_pairs(
                         x_sel, sids, rows, seed=MAIN_SEED))):
        kernels, busy, span = device_kernels(fn)
        print(f"[gen-full] {name} profiled: {len(kernels)} kernels, device "
              f"busy {busy:.1f} ms of a {span:.1f} ms span ({busy / span:.1%})")
    return launches


KERNEL_GROUPS = (("K1 ssim_kernel (cyclic mode)", ("ssim_kernel",)),
                 ("transposed conv (dgrad)", ("dgrad",)),
                 ("conv (fprop)", ("fprop", "cutlass")),
                 ("cuDNN layout/padding", ("Padding", "ToNhwc", "ToNchw")),
                 ("elementwise (bias, skip add, leaky_relu, tanh)",
                  ("elementwise",)))     # the rest: LSTM, GP, reductions


def print_kernel_groups(tag: str, kernels, busy: float, groups) -> None:
    """Device ms by group, each kernel in the first group whose key its
    name holds, and the top kernels by name."""
    sums = {name: 0.0 for name, _ in groups}
    rest = 0.0
    by_name = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + us / 1e3, n + 1)
        for name, keys in groups:
            if any(k in e.name for k in keys):
                sums[name] += us / 1e3
                break
        else:
            rest += us / 1e3
    for name, ms in list(sums.items()) + [("other", rest)]:
        print(f"{tag} {ms:9.2f} ms ({ms / busy:6.1%})  {name}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"{tag} top {ms:8.2f} ms {n:5d}x  {name[:100]}")


def phase_profile(fns, x):
    """Device time by kernel group over one protocol run, and the card's
    busy share of its first-to-last-kernel span."""
    kernels, busy, span = device_kernels(lambda: fns.diverse_metrics(x,
                                                                     seed=4))
    print(f"[profile] {len(kernels)} kernels, device busy {busy:.1f} ms of "
          f"a {span:.1f} ms span ({busy / span:.1%})")
    print_kernel_groups("[profile]", kernels, busy, KERNEL_GROUPS)


def cli_run(ckpt_dir: str, data_root: str, logs, *flags,
            dataset: str = "smmnist"):
    """One in-process run of the eval CLI on the card; every kernel's count
    set to 0 just before and read just after. → (wall s, K1 launches of
    each diverse_metrics call, the clips it scored, the best-column frames
    held before GIF encoding by file name, K2 launches, peak GiB)."""
    import torch
    from dvg_tpu_torch.cli import generate as gen_cli
    from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                             ssim_psnr_batch_images)
    per_call, clips, best = [], [], {}
    real_fns, real_gif = gen_cli.make_rollout_fns, gen_cli.save_gif_with_text

    def fns_counting(model, cfg):
        fns = real_fns(model, cfg)

        def diverse_metrics(x, **kw):
            before = ssim_psnr_batch_cyclic.launches
            out = fns.diverse_metrics(x, **kw)
            torch.cuda.synchronize()
            per_call.append(ssim_psnr_batch_cyclic.launches - before)
            clips.append(x)
            return out
        return fns._replace(diverse_metrics=diverse_metrics)

    def hold_best(path, gifs, texts, **kw):
        best[Path(path).name] = [row[2] for row in gifs]
        real_gif(path, gifs, texts, **kw)

    gen_cli.make_rollout_fns, gen_cli.save_gif_with_text = (fns_counting,
                                                            hold_best)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ssim_psnr_batch_cyclic.launches = 0
        ssim_psnr_batch_images.launches = 0
        t0 = time.perf_counter()
        rc = gen_cli.main(["--model_dir", ckpt_dir, "--log_dir", str(logs),
                           "--dataset", dataset, "--data_root", data_root,
                           "--num_batches", str(CLI_BATCHES), *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2 = ssim_psnr_batch_images.launches
    finally:
        gen_cli.make_rollout_fns = real_fns
        gen_cli.save_gif_with_text = real_gif
    check(rc == 0, f"the CLI returned {rc}")
    return (wall, per_call, clips, best, k2,
            torch.cuda.max_memory_allocated() / 2**30)


def read_records(logs) -> list:
    with open(Path(logs) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


def rescore_best(logs, clips, best, n_past: int, s_n: int):
    """The best-SSIM column of every GIF the eval CLI wrote (its frames held
    before GIF encoding by `cli_run`), re-scored by K2 against its batch's
    ground truth → ([max |Δssim|, max |Δpsnr|] against the npz scores of
    that future, K2 launches)."""
    import numpy as np
    import torch
    from dvg_tpu_torch.generate.rollout import best_of_n
    from dvg_tpu_torch.ops import ssim_cuda
    worst = [0.0, 0.0]
    ssim_cuda.ssim_psnr_batch_images.launches = 0
    for bi, x in enumerate(clips):
        b, w, n_free = x.shape[1], x.shape[2], x.shape[0] - n_past
        arrs = np.load(Path(logs) / f"eval_batch{bi}.npz")
        for k in ("ssim", "psnr"):
            check(arrs[k].shape == (b, s_n, n_free),
                  f"{k} shape {arrs[k].shape}")
            check(bool(np.isfinite(arrs[k]).all()), f"{k} not finite")
        idx, _ = best_of_n(torch.from_numpy(arrs["ssim"]))
        for i in range(min(b, 10)):
            tiles = best[f"sample_lstm_{bi * b + i}.gif"]
            pred = torch.as_tensor(np.stack(
                [t[1:w + 1, 1:w + 1, :x.shape[-1]] for t in tiles[n_past:]]),
                device=CARD)
            s_v, q_v, _ = ssim_cuda.ssim_psnr_batch_images(
                x[n_past:, i].contiguous(), pred)
            for j, (got, key) in enumerate(((s_v, "ssim"), (q_v, "psnr"))):
                worst[j] = max(worst[j], float(np.abs(
                    got.cpu().numpy() - arrs[key][i, int(idx[i])]).max()))
    return worst, ssim_cuda.ssim_psnr_batch_images.launches


def phase_cli(tmp: str):
    """The eval CLI at full width (module docstring, phase 10)."""
    import os
    import numpy as np
    import torch
    from dvg_tpu_torch.checkpoint import load_model, save_checkpoint
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    from dvg_tpu_torch.ops import ssim as plain
    from dvg_tpu_torch.ops import ssim_cuda
    tmp = Path(tmp)
    # the CLI runs under PyTorch's defaults, as a user's process has them
    # (phase 7 turned cudnn.benchmark on, phases 5-6 TF32 off); the CLI
    # turns TF32 off itself for an f32 run
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = True
    cfg = DVGConfig(**CLI_MODEL)
    ckpt = str(tmp / "cli_ckpt")
    save_checkpoint(ckpt, cfg, unit_gain_model(cfg, "cpu"))
    no_mnist = tmp / "no_mnist"
    no_mnist.mkdir()
    gen = cfg.generation_override()
    b, n_past, n_eval = gen.batch_size, gen.n_past, gen.n_eval
    n_free, s_n = n_eval - n_past, 100
    print(f"[cli] checkpoint: DCGAN-64 smmnist C 1 unit gain; protocol S "
          f"{s_n} B {b} n_eval {n_eval}, {CLI_BATCHES} batches of "
          "procedural digits (data_root holds no MNIST file)")
    for dtype in ("float32", "bfloat16"):
        logs = tmp / f"cli_{dtype}"
        wall, per_call, clips, best, k2, peak = cli_run(
            ckpt, str(no_mnist), logs, "--dtype", dtype)
        recs = read_records(logs)
        load_s = [r["ckpt_load_s"] for r in recs if r["kind"] == "setup"]
        times = [r for r in recs if r["kind"] == "time"]
        evals = [r for r in recs if r["kind"] == "eval"]
        gifs = sorted(p.name for p in logs.glob("sample_lstm_*.gif"))
        print(f"[cli] {dtype}: {wall:.2f} s wall for {CLI_BATCHES} batches; "
              f"checkpoint load {load_s[0]:.3f} s; K1 launches per batch "
              f"{per_call}; K2 launches {k2}; peak mem {peak:.2f} GiB; "
              f"{len(gifs)} GIFs, "
              f"{sum(p.stat().st_size for p in logs.glob('*.gif')) / 1e6:.1f}"
              " MB")
        for r in times:
            print(f"[cli] {dtype} batch {r['step']} s: assembly "
                  f"{r['batch_s']:.4f}  posterior {r['posterior_s']:.3f}  "
                  f"diverse_metrics {r['metrics_s']:.3f}  40-pair re-roll "
                  f"{r['reroll_s']:.3f}  10 GIFs {r['gifs_s']:.3f}")
        check(per_call == [n_free] * CLI_BATCHES,
              f"K1 launches per batch {per_call}, want {n_free}")
        check(len(evals) == CLI_BATCHES and len(times) == CLI_BATCHES,
              f"{len(evals)} eval and {len(times)} time records")
        check(len(gifs) == 10 * CLI_BATCHES, f"{len(gifs)} GIFs")
        for bi in range(CLI_BATCHES):
            check(all(np.isfinite(v) for v in (evals[bi]["ssim_best_mean"],
                                               evals[bi]["psnr_mean"])),
                  "eval record not finite")
        worst, _ = rescore_best(logs, clips, best, n_past, s_n)
        tol = CLI_TOL[dtype]
        print(f"[cli] {dtype}: best-SSIM column of every GIF re-scored by K2 "
              f"vs the npz scores: max|dssim| {worst[0]:.3e}  max|dpsnr| "
              f"{worst[1]:.3e} dB  (tol {tol})")
        check(worst[0] <= tol["ssim_atol"] and worst[1] <= tol["psnr_atol"],
              f"{dtype}: the GIF's best column is not the scored future: "
              f"{worst}")
        del clips, best
        torch.cuda.empty_cache()

    # K1 alone at C 1, the CLI's step shape
    for dt in (torch.float32, torch.bfloat16):
        gt, pred = kernel_inputs(torch.device(CARD), s_n, b, 64, 1, seed=9)
        pred = pred.to(dt)
        errs = max_errs(ssim_cuda.ssim_psnr_batch_cyclic(gt, pred),
                        plain.ssim_psnr_cyclic_plain(gt, pred))
        check(within(errs, K1_TOL), f"K1 C 1 disagrees: {errs}")
        k_ms = cuda_ms(lambda: ssim_cuda.launch(gt, pred), 20)
        nbytes, flops = k1_cost(s_n, b, 64, 64, 1, pred.element_size())
        b_ms, b_by = bound(nbytes, flops)
        print(f"[cli] K1 C 1 {tuple(pred.shape)} {str(dt)[6:]} pred: kernel "
              f"{k_ms * 1e3:.1f} us/launch, bound {b_ms * 1e3:.1f} us by "
              f"{b_by} = {b_ms / k_ms:.1%}; vs plain max|dssim| "
              f"{errs[0]:.3e}")

    # the GP-trigger path: at the seeded GP's constant variance the window's
    # std is 0, so a positive margin fires every decision
    cwd = os.getcwd()
    trig_dir = tmp / "trigger_cwd"
    trig_dir.mkdir()
    os.chdir(trig_dir)
    try:
        t0 = time.perf_counter()
        from dvg_tpu_torch.cli import generate as gen_cli
        rc = gen_cli.main(["--model_dir", ckpt, "--log_dir",
                           str(tmp / "cli_trigger"), "--dataset", "smmnist",
                           "--data_root", str(no_mnist), "--num_batches", "1",
                           "--gp_trigger_flag", "--trigger_margin", "1e-3"])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    check(rc == 0, f"the trigger run returned {rc}")
    strips = list(trig_dir.glob("recursive_generation/*/*.png"))
    recs = read_records(tmp / "cli_trigger")
    trig = [r for r in recs if r["kind"] == "trigger"]
    t_rec = [r for r in recs if r["kind"] == "time"][0]
    want = b * (n_eval - 12)
    print(f"[cli] gp-trigger B {b} n_eval {n_eval}: {len(strips)} strips, "
          f"{trig[0]['triggers']:.0f} of {want} decisions fired (margin "
          f"1e-3); rollout {t_rec['trigger_s']:.3f} s, strips "
          f"{t_rec['strips_s']:.3f} s, {wall:.2f} s wall")
    check(len(strips) == b, f"{len(strips)} strips, want {b}")
    check(len(trig) == 1 and trig[0]["triggers"] == want,
          f"trigger records {trig}, want {want} decisions")

    # the Finn and kernel-free routes: card against CPU on the tiny config
    torch.backends.cudnn.allow_tf32 = False
    tiny = DVGConfig(**TINY)
    rng = np.random.RandomState(4)
    x = (rng.rand(tiny.n_eval, tiny.batch_size, 64, 64, 3) * 2 - 1
         ).astype(np.float32)
    noise = rng.randn(tiny.n_eval - tiny.n_past, tiny.nsample,
                      tiny.batch_size, tiny.g_dim).astype(np.float32)
    for name, kw in ROUTES[1:]:
        outs = {}
        for dev in ("cpu", CARD):
            ssim_cuda.ssim_psnr_batch_cyclic.launches = 0
            out = make_rollout_fns(unit_gain_model(tiny, dev),
                                   tiny.replace(**kw)).diverse_metrics(
                x, noise=noise, device=dev)
            outs[dev] = [out[k].cpu() for k in METRICS]
            check(ssim_cuda.ssim_psnr_batch_cyclic.launches == 0,
                  f"the {name} route launched K1")
        errs = max_errs(outs[CARD], outs["cpu"])
        print(f"[cli] tiny f32 {name} route card vs cpu: max|dssim| "
              f"{errs[0]:.3e}  max|dpsnr| {errs[1]:.3e} dB  max rel dmse "
              f"{errs[2]:.3e}  (tol {ROUTE_TOL})")
        check(within(errs, ROUTE_TOL), f"{name} route card vs CPU: {errs}")

    # each route timed at full width, bf16, on the CLI checkpoint
    _, model = load_model(ckpt, device=CARD)
    xg = torch.rand((n_eval, b, 64, 64, 1),
                    generator=torch.Generator(device=CARD).manual_seed(3),
                    device=CARD)
    for name, kw in ROUTES:
        fns = make_rollout_fns(model, gen.replace(
            **{"dtype": "bfloat16", "nsample": s_n, "use_pallas": True, **kw}))
        _, ms = events_ms(lambda: fns.diverse_metrics(xg, seed=1,
                                                      device=CARD))
        print(f"[cli] route {name}: diverse_metrics bf16 S {s_n} B {b} C 1 "
              f"n_free {n_free}: {ms:.1f} ms (one call)")
    loaded = [m for m in ("PIL", "imageio") if m in sys.modules]
    print(f"[cli] PIL/imageio imported: {loaded or 'none'}")
    check(not loaded, f"the CLI phase imported {loaded}")


# ---------------------------------------------------------------------------
# [train]: the train step (phase 11)
# ---------------------------------------------------------------------------

def noise_bias(name: str) -> bool:
    """A conv bias that feeds a train-mode BN: the BN subtracts the batch
    mean it shifts, so its gradient is zero but for rounding, and Adam's
    first step lr·g/(|g| + 1e-8) gives it the sign of that rounding."""
    return name.endswith("conv.bias") and not name.startswith("decoder.final")


def grad_errs(got: dict, want: dict, allow: dict):
    """(worst ‖Δg‖/‖g‖ / allowed over the real gradients, its error and
    tensor; worst ‖g‖ of a noise bias over ‖g‖ of its conv weight, on
    either side)."""
    rel, noise = (0.0, 0.0, ""), 0.0
    for k, w in want.items():
        g = got[k].to("cpu", w.dtype)
        if noise_bias(k):
            scale = want[k.replace("bias", "weight")].norm().item()
            noise = max(noise, g.norm().item() / scale,
                        w.norm().item() / scale)
        else:
            err = ((g - w).norm() / w.norm()).item()
            rel = max(rel, (err / allow[k], err, k))
    return rel, noise


def stats_err(pairs) -> float:
    """max |a − b| / max(1, |b|) over (a, b) pairs of BN statistics: an
    absolute error where they are O(1), relative where (unit-gain weights)
    the pre-BN maps' variances run to hundreds."""
    return max(((a.double().cpu() - b.double().cpu()).abs()
                / b.double().cpu().abs().clamp(min=1)).max().item()
               for a, b in pairs)


def joint_conditioning(model, x, cfg) -> dict:
    """Per parameter, ‖Δg‖/‖g‖ of the joint pass's real gradients, in f64
    on the CPU, when every weight and the clip move by an f32-sized
    relative perturbation (1e-7·N(0, 1)): how far f32 rounding alone can
    move them. Per-frame BN over a small batch makes some of them move
    far more than the perturbation."""
    import torch
    from dvg_tpu_torch.train import step as train_step
    plan = train_step.make_plan(cfg, x.shape[0], torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)

    def grads(m, xx):
        loss, *_ = train_step.joint_loss(m, xx, cfg, plan)
        loss.backward()
        return {k: p.grad for k, p in m.named_parameters()
                if not noise_bias(k)}

    x64 = torch.as_tensor(x)
    g0 = grads(copy.deepcopy(model).double(), x64)
    moved = copy.deepcopy(model).double()
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen,
                                          dtype=p.dtype))
    g1 = grads(moved, x64 * (1 + 1e-7 * torch.randn(
        x64.shape, generator=gen, dtype=x64.dtype)))
    return {k: ((g1[k] - g0[k]).norm() / g0[k].norm()).item() for k in g0}


def train_tiny_run(init, x, cfg, dev, dtype):
    """The tiny config from `init` on `dev` in `dtype`: the joint pass's
    gradients at the init, on the layout the step uses (so that cuDNN
    takes the step's algorithms and the rounding is the step's); the model
    after the joint pass alone (a step with cfg.ft off: its update and fold
    are the full step's first half); the metrics and state of a full
    step."""
    import torch
    from dvg_tpu_torch.train import make_train_step, train_state
    from dvg_tpu_torch.train import step as train_step
    model = train_state(copy.deepcopy(init).to(dev, dtype), cfg).model
    plan = train_step.make_plan(cfg, cfg.seq_len_train, torch.device(dev))
    loss, *_ = train_step.joint_loss(
        model, torch.as_tensor(x, dtype=dtype, device=dev), cfg, plan)
    loss.backward()
    joint_cfg = cfg.replace(ft=False)
    joint = train_state(copy.deepcopy(init).to(dev, dtype), joint_cfg)
    make_train_step(joint_cfg)(joint, x)
    state = train_state(copy.deepcopy(init).to(dev, dtype), cfg)
    _, metrics = make_train_step(cfg)(state, x)
    return {"grads": {k: p.grad for k, p in model.named_parameters()},
            "snap": joint.model.cpu(), "state": state,
            "metrics": {k: v.item() for k, v in metrics.items()}}


def finetune_at(snap, x, cfg, dev, dtype):
    """The finetune passes from `snap` on `dev` in `dtype`: (their
    losses, LSTM grads, GP grads, per-frame encode statistics)."""
    import torch
    from dvg_tpu_torch.train import step as train_step
    model = copy.deepcopy(snap).to(dev, dtype)
    plan = train_step.make_plan(cfg, cfg.seq_len_train, torch.device(dev))
    h_all, enc = train_step.finetune_encode(
        model, torch.as_tensor(x, dtype=dtype, device=dev), plan)
    out = []
    for loss_fn, prefix in ((lambda: train_step.lstm_finetune_loss(
            model, h_all, plan), ("frame_predictor",)),
            (lambda: train_step.gp_finetune_loss(model, h_all),
             ("gp.", "likelihood."))):
        model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        out.append((loss.item(), {k: p.grad for k, p in
                                  model.named_parameters()
                                  if k.startswith(prefix)}))
    return (out[0][0], out[1][0]), out[0][1], out[1][1], enc


def phase_train_tiny():
    """(a) of phase 11: one step of the tiny config on the card, in f64
    and in f32, against one on the CPU in f64. f64 on the card holds the
    port's card path to the CPU's; f32 holds its rounding, against the
    tolerances or, for a tensor the clip makes ill-conditioned, 100× the
    movement an f32-sized perturbation gives it in f64 (joint_conditioning)."""
    import numpy as np
    import torch
    from dvg_tpu_torch.config import DVGConfig
    backends = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = DVGConfig(**TRAIN_TINY)
    tol = TRAIN_TOL
    x = np.random.RandomState(TRAIN_TINY_SEED).rand(
        cfg.seq_len_train, cfg.batch_size, 64, 64, 3)
    init = with_trained_gp(unit_gain_model(cfg, "cpu"), seed=2)
    cond = joint_conditioning(init, x, cfg)
    worst = sorted(cond.items(), key=lambda kv: -kv[1])[:3]
    print(f"[train tiny] B {cfg.batch_size} T {cfg.seq_len_train} g_dim "
          f"{cfg.g_dim}; an f32-sized (1e-7) change of the weights and the "
          f"clip moves the f64 joint grads by up to "
          + ", ".join(f"{v:.1e} ({k})" for k, v in worst))
    cpu = train_tiny_run(init, x, cfg, "cpu", torch.float64)
    ft_cpu = finetune_at(cpu["snap"], x, cfg, "cpu", torch.float64)
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        allow = {k: tol["grad_rel"] if dtype == torch.float64 else
                 max(tol["grad_rel"], 100 * c) for k, c in cond.items()}
        card = train_tiny_run(init, x, cfg, CARD, dtype)
        # the joint pass's metrics; the finetune losses are held below at
        # the CPU's post-joint point (after its own joint step the card's
        # params differ where Adam's first update took the sign of a
        # rounding-level gradient)
        rel = {k: abs(card["metrics"][k] - v) / abs(v)
               for k, v in cpu["metrics"].items()}
        m_err, m_at = max((v, k) for k, v in rel.items()
                          if not k.startswith("ft_"))
        (g_ratio, g_err, g_at), noise = grad_errs(card["grads"],
                                                  cpu["grads"], allow)
        snap_card = card["snap"].state_dict()
        s_err = stats_err((snap_card[k], v) for k, v in
                          cpu["snap"].state_dict().items() if "running" in k)
        print(f"[train tiny] card {name} vs cpu f64: joint metrics max rel "
              f"{m_err:.2e} ({m_at}; after each device's own joint step "
              f"ft_mse_latent {rel['ft_mse_latent']:.1e}, ft_gp_nll "
              f"{rel['ft_gp_nll']:.1e}); joint grads max rel {g_err:.2e} "
              f"({g_at}, {g_ratio:.2f} of its allowance); noise biases' "
              f"grads <= {noise:.1e} x their weights'; stats after the joint "
              f"fold max err {s_err:.2e}  (tol {tol}; stats: abs where "
              f"O(1), else relative)")
        check(m_err <= tol["metric_rtol"], f"{name} metrics {m_err} {m_at}")
        check(g_ratio <= 1, f"{name} joint grads {g_err} ({g_at})")
        check(noise <= 1e-4, f"a noise bias has a real gradient: {noise}")
        check(s_err <= tol["stats_atol"], f"{name} joint-fold stats {s_err}")

        # the finetune passes on the card at the CPU's post-joint point
        losses, fp, gp, enc = finetune_at(cpu["snap"], x, cfg, CARD, dtype)
        l_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ft_cpu[0]))
        (fp_ratio, fp_err, fp_at), _ = grad_errs(fp, ft_cpu[1], allow)
        (gp_ratio, gp_err, gp_at), _ = grad_errs(gp, ft_cpu[2], allow)
        e_err = stats_err((a, b) for pa, pb in zip(enc, ft_cpu[3])
                          for a, b in zip(pa, pb))
        print(f"[train tiny] card {name}, finetune passes at the CPU's "
              f"post-joint params: losses max rel {l_err:.2e}; LSTM grads "
              f"max rel {fp_err:.2e} ({fp_at}); GP grads max rel "
              f"{gp_err:.2e} ({gp_at}); per-frame encode stats max err "
              f"{e_err:.2e}")
        check(l_err <= tol["metric_rtol"], f"{name} finetune losses {l_err}")
        check(max(fp_ratio, gp_ratio) <= 1,
              f"{name} finetune grads {fp_err} {gp_err}")
        check(e_err <= tol["stats_atol"], f"{name} finetune stats {e_err}")

        # post-step encoder and decoder params: stepped once, by the joint
        # pass from identical params; compared where the gradient's sign
        # is not set by rounding (|g| >= 1e-6, within 10% card vs CPU)
        after = card["state"].model.state_dict()
        ref = cpu["state"].model.state_dict()
        worst_p, kept, total = 0.0, 0, 0
        for k, g_cpu in cpu["grads"].items():
            if not k.startswith(("encoder", "decoder")) or noise_bias(k):
                continue
            g_card = card["grads"][k].to("cpu", torch.float64)
            sure = (g_cpu.abs() >= 1e-6) & ((g_card - g_cpu).abs()
                                            <= 0.1 * g_cpu.abs())
            d = (after[k].to("cpu", torch.float64) - ref[k]).abs()
            worst_p = max(worst_p, d[sure].max().item())
            kept, total = kept + int(sure.sum()), total + sure.numel()
        print(f"[train tiny] card {name}, post-step encoder/decoder params "
              f"(noise biases excluded) at the {kept} of {total} elements "
              f"whose gradient sign is sure: max abs {worst_p:.2e} (atol "
              f"{tol['param_atol']})")
        check(worst_p <= tol["param_atol"], f"{name} post-step params "
              f"{worst_p}")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = backends


def train_step_cost(cfg, n_params: int):
    """(operations, bytes) one train step must at least do and move: the
    convolutions and LSTM/linear GEMMs of the joint pass forward and
    backward (twice the forward, less the unneeded input gradient of the
    first conv) and the finetune encode and LSTM passes; the clip read once
    and every parameter's Adam traffic (read p, g, m, v; write p, m, v) in
    f32. The GP's 40×40 algebra (under 0.1 GFLOP) is left out."""
    nf, c, g, h = 64, cfg.channels, cfg.g_dim, cfg.rnn_size
    t, b = cfg.seq_len_train, cfg.batch_size
    enc = [(32, c, nf), (16, nf, 2 * nf), (8, 2 * nf, 4 * nf),
           (4, 4 * nf, 8 * nf), (1, 8 * nf, g)]      # (out side, c_in, c_out)
    enc_f = sum(2 * s * s * co * 16 * ci for s, ci, co in enc)
    first = 2 * 32 * 32 * nf * 16 * c
    # transposed convs: 2·in_pixels·c_in·c_out·16; each stage's d half and
    # skip half are equal, and the skip half runs once per unique frame
    half = sum(2 * s * s * ci * co * 16 for s, ci, co in
               ((4, 8 * nf, 4 * nf), (8, 4 * nf, 2 * nf), (16, 2 * nf, nf),
                (32, nf, c)))
    head = 2 * g * 8 * nf * 16
    calls, uniq = 3 * (t - 1), max(cfg.n_past - 1, 1)
    lstm = (t - 1) * b * (2 * g * h + cfg.predictor_rnn_layers * 16 * h * h
                          + 2 * h * g)
    joint = t * b * enc_f + calls * b * (head + half) + uniq * b * half + lstm
    flops = 3 * joint - t * b * first + t * b * enc_f + 3 * lstm
    nbytes = t * b * 64 * 64 * c * 4 + 7 * 4 * n_params
    return flops, nbytes


TRAIN_GROUPS = (("conv wgrad", ("wgrad",)),
                ("conv dgrad (incl. transposed-conv forward)", ("dgrad",)),
                ("conv fprop (incl. transposed-conv dgrad)",
                 ("fprop", "implicit_convolve", "conv2d", "xmma", "cutlass")),
                ("BN statistics (Welford)", ("Welford", "welford")),
                ("other reductions", ("reduce_kernel",)),
                ("LSTM (cuDNN RNN)", ("RNN", "rnn", "LSTM", "lstm",
                                      "elemWise")),
                ("GEMM / GP solves", ("gemm", "Gemm", "trsm", "potrf",
                                      "cholesky", "geqrf")),
                ("Adam (foreach)", ("multi_tensor_apply",)),
                ("index_select / index_add", ("index",)),
                ("copies and layout", ("copy", "Copy", "nchw", "nhwc",
                                       "Nhwc", "Nchw", "Padding")),
                ("elementwise", ("elementwise", "vectorized")))


def phase_train_full():
    """(b) of phase 11: the step at the bench's training geometry."""
    import torch
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                             ssim_psnr_batch_images)
    from dvg_tpu_torch.train import init_train_state, make_train_step
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = False
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    for dtype in ("float32", "bfloat16"):
        cfg = DVGConfig(**TRAIN_FULL, dtype=dtype)
        # f32 means f32 arithmetic, as the training CLI runs it
        torch.backends.cudnn.allow_tf32 = dtype != "float32"
        torch.backends.cuda.matmul.allow_tf32 = dtype != "float32"
        state = init_train_state(cfg, device=CARD)
        n_params = sum(p.numel() for p in state.model.parameters())
        g = torch.Generator(device=CARD).manual_seed(6)
        x = torch.rand((cfg.seq_len_train, cfg.batch_size, 64, 64, 3),
                       generator=g, device=CARD)
        step = make_train_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, m0 = step(state, x)                 # warm-up: step 0's loss
        loss0 = m0["loss"].item()
        warm_s = time.perf_counter() - t0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ssim_psnr_batch_cyclic.launches = 0
        ssim_psnr_batch_images.launches = 0
        t0 = time.perf_counter()
        start.record()
        for _ in range(TRAIN_STEPS):
            _, metrics = step(state, x)
        end.record()
        torch.cuda.synchronize()
        launches = (ssim_psnr_batch_cyclic.launches,
                    ssim_psnr_batch_images.launches)
        host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        ms = start.elapsed_time(end) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = all(torch.isfinite(v).item() for v in metrics.values())
        loss = metrics["loss"].item()
        flops, nbytes = train_step_cost(cfg, n_params)
        rate = F32_FLOP_PER_S if dtype == "float32" else BF16_FLOP_PER_S
        t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        b_ms, b_by = max((t_ops, "operations"), (t_bytes, "bytes"))
        print(f"[train full] {dtype} DCGAN-64 C 3 B {cfg.batch_size} T "
              f"{cfg.seq_len_train} g_dim {cfg.g_dim} rnn "
              f"{cfg.rnn_size}x{cfg.predictor_rnn_layers} M "
              f"{cfg.num_inducing_points} ft: {ms:.2f} ms/step (events, "
              f"{TRAIN_STEPS} pipelined steps; host {host_ms:.2f} ms/step; "
              f"warm-up step {warm_s:.2f} s, cudnn.benchmark on); peak mem "
              f"{peak:.2f} GiB; {n_params:,} params; bound {b_ms:.2f} ms by "
              f"{b_by} ({flops / 1e12:.3f} TFLOP at {rate / 1e12:.0f} "
              f"TFLOP/s, {nbytes / 1e6:.0f} MB) = {b_ms / ms:.1%} of bound; "
              f"loss step 0 {loss0:.4f} -> after {TRAIN_STEPS} steps "
              f"{loss:.4f}; finite {finite}; K1, K2 launches {launches}")
        check(finite, f"{dtype}: a train metric is not finite")
        check(launches == (0, 0), f"the train step launched K1/K2 {launches}")
        check(loss < loss0, f"{dtype}: the joint loss did not fall on a fixed "
              f"batch ({loss0} -> {loss})")
        check(all(p.dtype == torch.float32
                  for p in state.model.parameters()),
              "master params are not f32")
        kernels, busy, span = device_kernels(lambda: step(state, x))
        print(f"[train full] {dtype} profiled step: {len(kernels)} kernels, "
              f"device busy {busy:.1f} ms of a {span:.1f} ms span "
              f"({busy / span:.1%})")
        print_kernel_groups(f"[train full] {dtype}", kernels, busy,
                            TRAIN_GROUPS)
        del state, x, step
        torch.cuda.empty_cache()
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32
    torch.backends.cudnn.benchmark = False


def phase_train_cli(tmp: str):
    """(c) of phase 11: the training CLI trains, resumes and hands its
    checkpoint to the eval CLI."""
    import torch
    from dvg_tpu_torch.checkpoint import load_checkpoint
    from dvg_tpu_torch.cli import train as train_cli
    tmp = Path(tmp)
    run, no_mnist = tmp / "train_run", tmp / "train_no_mnist"
    no_mnist.mkdir()
    args = ["--dataset", "smmnist", "--data_root", str(no_mnist),
            "--output_path", str(run), "--log_dir", str(run / "logs"),
            "--epoch_size", str(TRAIN_CLI_EPOCH), "--ckpt_every", "1"]
    t0 = time.perf_counter()
    check(train_cli.main(args + ["--niter", "2"]) == 0, "train CLI failed")
    first_s = time.perf_counter() - t0
    files = sorted(p.name for p in run.iterdir())
    recs = [r for r in read_records(run / "logs") if r["kind"] == "epoch"]
    trained_cfg, _, payload = load_checkpoint(str(run))
    step_two = int(payload["step"])
    t0 = time.perf_counter()
    check(train_cli.main(args + ["--niter", "3", "--resume"]) == 0,
          "train CLI --resume failed")
    resume_s = time.perf_counter() - t0
    recs3 = [r for r in read_records(run / "logs") if r["kind"] == "epoch"]
    step_three = int(load_checkpoint(str(run))[2]["step"])
    for r in recs3:
        print(f"[train cli] f32 smmnist C 1 B 50 T 15: epoch {r['step']} "
              f"{r['step_s'] * TRAIN_CLI_EPOCH:.3f} s ({r['step_s'] * 1e3:.1f}"
              f" ms/step), epoch_mse {r['epoch_mse']:.5f}")
    print(f"[train cli] --niter 2: {first_s:.2f} s wall, files {files}, "
          f"checkpoint step {step_two}; --resume --niter 3: {resume_s:.2f} s "
          f"wall, epochs {[r['step'] for r in recs3]}, checkpoint step "
          f"{step_three}")
    want = {"model.ckpt", "sample_0.png", "sample_0.gif", "sample_1.png",
            "sample_1.gif"}
    check(want <= set(files), f"train CLI files {files}")
    check([r["step"] for r in recs] == [0, 1], f"epoch records {recs}")
    check(step_two == 2 * TRAIN_CLI_EPOCH and
          step_three == 3 * TRAIN_CLI_EPOCH and
          [r["step"] for r in recs3] == [0, 1, 2],
          f"resume: steps {step_two}, {step_three}, records {recs3}")
    check(all(math.isfinite(r["epoch_mse"]) for r in recs3),
          "epoch_mse not finite")
    wall, per_call, _, _, k2, peak = cli_run(str(run), str(no_mnist),
                                             tmp / "train_eval")
    print(f"[train cli] eval CLI on the trained checkpoint: {wall:.2f} s "
          f"wall, K1 launches per batch {per_call}, K2 launches {k2}, peak "
          f"{peak:.2f} GiB")
    n_free = trained_cfg.generation_override().n_eval - trained_cfg.n_past
    check(per_call == [n_free] * CLI_BATCHES,
          f"K1 launches per batch {per_call}, want {n_free}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# [backbones]: VGG-64, VGG-128 and DCGAN-128 (phase 12)
# ---------------------------------------------------------------------------

def counted_flops(fn) -> int:
    """The FLOPs of the convolutions and matrix products fn() runs
    (torch.utils.flop_counter, from the ops' shapes; K1 and K2 are not
    torch ops and are left out)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def phase_backbones_tiny():
    """(a): each backbone's tiny config, card against CPU: f32
    diverse_metrics (K1 on the card, its plain version on the CPU, TF32
    off) at PATH_TOL; the exact re-roll on the card at REROLL_TOL; one f64
    train step."""
    import numpy as np
    import torch
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                             ssim_psnr_batch_images)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, kw, _ in BACKBONES:
        cfg = DVGConfig(**dict(BB_TINY, **kw))
        w, n_free = cfg.image_width, cfg.n_eval - cfg.n_past
        rng = np.random.RandomState(0)
        x = rng.rand(cfg.n_eval, cfg.batch_size, w, w, 3).astype(np.float32)
        noise = rng.randn(n_free, cfg.nsample, cfg.batch_size,
                          cfg.g_dim).astype(np.float32)
        outs = {}
        model = with_trained_gp(unit_gain_model(cfg, "cpu"), seed=2)
        for dev in ("cpu", CARD):
            ssim_psnr_batch_cyclic.launches = 0
            fns = make_rollout_fns(copy.deepcopy(model).to(dev), cfg)
            out = fns.diverse_metrics(x, noise=noise, device=dev)
            if dev == CARD:
                torch.cuda.synchronize()
            launches = ssim_psnr_batch_cyclic.launches
            outs[dev] = [out[k].cpu() for k in METRICS]
        errs = max_errs(outs[CARD], outs["cpu"])
        fork = n_free - 2                  # step 15 of n_past 2, n_eval 17
        spread = np.ptp(outs["cpu"][2][:, fork].numpy(), axis=0).min()
        print(f"[backbones tiny] {name} f32 diverse_metrics (S, n_free, B) "
              f"{tuple(outs[CARD][0].shape)} card vs cpu: max|dssim| "
              f"{errs[0]:.3e}  max|dpsnr| {errs[1]:.3e} dB  max rel dmse "
              f"{errs[2]:.3e}  (tol {PATH_TOL}); K1 launches {launches}; "
              f"samples' mse spread at the fork {spread:.2e}")
        check(all(bool(torch.isfinite(v).all()) for v in outs[CARD]),
              f"{name}: tiny metrics not finite")
        check(within(errs, PATH_TOL), f"{name} tiny card vs CPU: {errs}")
        check(launches == n_free, f"{name}: K1 launched {launches} times, "
              f"not {n_free}")
        # the exact re-roll on the card (f32): the futures that
        # diverse_select_pairs re-rolls, scored by K2, give the scores K1
        # gave them in the loop
        met = fns.diverse_metrics(x, seed=11, device=CARD)
        pairs = [(2, 1), (0, 0), (1, 1), (2, 0)]            # (sample, row)
        ids, rows = [p[0] for p in pairs], [p[1] for p in pairs]
        frames = fns.diverse_select_pairs(x[:, rows], ids, rows, seed=11,
                                          device=CARD)
        img = (w, w, 3)
        scored = ssim_psnr_batch_images(
            torch.as_tensor(x[cfg.n_past:, rows], device=CARD).reshape(
                (-1,) + img), frames[cfg.n_past:].reshape((-1,) + img))
        scored = [v.reshape(n_free, len(pairs)).cpu() for v in scored]
        ref = [torch.stack([met[k][s, :, r].cpu() for s, r in pairs], dim=1)
               for k in METRICS]
        r_errs = max_errs(scored, ref)
        print(f"[backbones tiny] {name} f32 re-roll of {len(pairs)} pairs "
              f"scored by K2 vs their in-loop K1 scores: max|dssim| "
              f"{r_errs[0]:.3e}  max|dpsnr| {r_errs[1]:.3e} dB  max rel "
              f"dmse {r_errs[2]:.3e}  (tol {REROLL_TOL})")
        check(within(r_errs, REROLL_TOL), f"{name}: the re-roll does not "
              f"reproduce the scored futures: {r_errs}")
        check(spread > 0, f"{name}: the fork did not separate the samples")
        backbone_train_tiny(name, DVGConfig(**dict(BB_TRAIN_TINY, **kw)))


def backbone_train_tiny(name: str, cfg):
    """One f64 train step of `cfg` on the card against one on the CPU,
    from the same unit-gain weights and clip (cuDNN deterministic): the
    metrics, the joint pass's gradients at the init, the post-step encoder
    and decoder weights where their gradient is at least 1e-6 (as phase
    11a: Adam's first update is ±lr there, whatever the rounding; the conv
    biases that feed a train-mode BN have rounding-level gradients and are
    left out), and every running variance."""
    import numpy as np
    import torch
    from dvg_tpu_torch.train import make_train_step, train_state
    from dvg_tpu_torch.train import step as train_step
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    w, tol = cfg.image_width, BB_F64_TOL
    x = np.random.RandomState(TRAIN_TINY_SEED).rand(
        cfg.seq_len_train, cfg.batch_size, w, w, 3)
    init = with_trained_gp(unit_gain_model(cfg, "cpu"), seed=2)
    runs = {}
    for dev in ("cpu", CARD):
        model = train_state(copy.deepcopy(init).to(dev, torch.float64),
                            cfg).model
        plan = train_step.make_plan(cfg, cfg.seq_len_train,
                                    torch.device(dev))
        loss, *_ = train_step.joint_loss(
            model, torch.as_tensor(x, device=dev), cfg, plan)
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        state = train_state(copy.deepcopy(init).to(dev, torch.float64), cfg)
        _, metrics = make_train_step(cfg)(state, x)
        runs[dev] = (grads, {k: v.item() for k, v in metrics.items()},
                     {k: v.cpu() for k, v in
                      state.model.state_dict().items()})
    torch.backends.cudnn.deterministic = deterministic
    (g_card, m_card, sd_card), (g_cpu, m_cpu, sd_cpu) = runs[CARD], \
        runs["cpu"]
    m_err = max(abs(m_card[k] - v) / abs(v) for k, v in m_cpu.items())
    (g_ratio, g_err, g_at), noise = grad_errs(
        g_card, g_cpu, {k: tol["grad_rel"] for k in g_cpu})
    p_err, p_at = 0.0, ""
    for k, v in sd_cpu.items():
        if not k.startswith(("encoder", "decoder")) or noise_bias(k) \
                or k not in g_cpu:
            continue
        # where the update saturates at ±lr: near |g| ~ eps = 1e-8 Adam's
        # first step moves a weight by lr/eps times the gradient's rounding
        d = (sd_card[k] - v).abs()[g_cpu[k].abs() >= 1e-6]
        if d.numel():
            p_err, p_at = max((p_err, p_at), (d.max().item(), k))
    v_err = max(((sd_card[k] - v).abs() / v.abs()).max().item()
                for k, v in sd_cpu.items() if "running_var" in k)
    print(f"[backbones tiny] {name} f64 train step B {cfg.batch_size} T "
          f"{cfg.seq_len_train} card vs cpu: metrics max rel {m_err:.2e}; "
          f"joint grads max rel {g_err:.2e} ({g_at}); noise biases' grads "
          f"<= {noise:.1e} x their weights'; post-step encoder/decoder "
          f"weights where |g| >= 1e-6 max abs err {p_err:.2e} ({p_at}); "
          f"running variances max rel err {v_err:.2e}  (tol {tol})")
    check(m_err <= tol["metric_rtol"], f"{name} f64 metrics {m_err}")
    check(g_ratio <= 1, f"{name} f64 joint grads {g_err} ({g_at})")
    check(noise <= 1e-4, f"{name}: a noise bias has a real gradient")
    check(p_err <= tol["param_atol"], f"{name} f64 post-step {p_at} "
          f"{p_err}")
    check(v_err <= tol["var_rtol"], f"{name} f64 running variances {v_err}")


def phase_backbones_full(tmp: str) -> dict:
    """(b): each backbone at full width in bf16 from a dvg_tpu checkpoint
    of seeded weights: the protocol timed, K1 counted, profiled, and its
    bound from the counted FLOPs."""
    import torch
    from dvg_tpu_torch.checkpoint import load_model, save_checkpoint
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    from dvg_tpu_torch.models.dvg import DVGModel
    from dvg_tpu_torch.ops.epilogue import conv_epilogue, conv_epilogue_pool
    from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                             ssim_psnr_batch_images)
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    results = {}
    for name, kw, b in BACKBONES:
        t0 = time.perf_counter()
        cfg = DVGConfig(**dict(HEADLINE, **kw, batch_size=b))
        model = DVGModel(cfg, seed=0, device=CARD)
        path = save_checkpoint(str(Path(tmp) / f"bb_{name}"), cfg, model)
        cfg2, loaded = load_model(path, device=CARD)
        want, got = model.state_dict(), loaded.state_dict()
        check(cfg2 == cfg and want.keys() == got.keys() and all(
            torch.equal(want[k], got[k]) for k in want),
            f"{name}: the checkpoint did not come back equal")
        del model, want, got
        s_n, w = cfg.nsample, cfg.image_width
        n_free = cfg.n_eval - cfg.n_past
        g = torch.Generator(device=CARD).manual_seed(1)
        x = torch.rand((cfg.n_eval, b, w, w, 3), generator=g, device=CARD)
        fns = make_rollout_fns(loaded, cfg2)
        fns.diverse_metrics(x, seed=2)                   # warm-up
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ssim_psnr_batch_cyclic.launches = 0
        ssim_psnr_batch_images.launches = 0
        conv_epilogue.launches = conv_epilogue_pool.launches = 0
        out, ms = events_ms(lambda: fns.diverse_metrics(x, seed=MAIN_SEED))
        launches = (ssim_psnr_batch_cyclic.launches,
                    ssim_psnr_batch_images.launches)
        k3, pooled = conv_epilogue.launches, conv_epilogue_pool.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        frames = s_n * n_free * b
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        for k, v in out.items():
            check(tuple(v.shape) == (s_n, n_free, b),
                  f"{name} {k} shape {tuple(v.shape)}")
        check(finite, f"{name}: a protocol metric is not finite")
        check(launches == (n_free, 0), f"{name}: K1, K2 launched "
              f"{launches} times, want ({n_free}, 0)")
        check(k3 == k3_per_call(cfg2), f"{name}: K3 launched {k3} times, "
              f"want {k3_per_call(cfg2)}")
        check(pooled == pool_per_call(cfg2), f"{name}: K3's pooled form "
              f"launched {pooled} times, want {pool_per_call(cfg2)}")
        kernels, busy, span = device_kernels(
            lambda: fns.diverse_metrics(x, seed=4))
        k1 = [e.time_range.elapsed_us() for e in kernels
              if "ssim_kernel" in e.name]
        k1_us = sum(k1) / max(len(k1), 1)
        k1_bytes, k1_flops = k1_cost(s_n, b, w, w, 3, 2)
        k1_bound_us = bound(k1_bytes, k1_flops)[0] * 1e3
        f1, f2 = (counted_flops(lambda n=n: make_rollout_fns(
            loaded, cfg2.replace(nsample=n)).diverse_metrics(x, seed=5))
            for n in (1, 2))
        flops = f1 + (s_n - 1) * (f2 - f1)
        b_ms = flops / BF16_FLOP_PER_S * 1e3
        print(f"[backbones full] {name} bf16 S {s_n} B {b} n_free {n_free} "
              f"({CARD_LINE}): {ms:.1f} ms/protocol, {frames / (ms / 1e3):,.0f}"
              f" frames/s; K1 launches {launches[0]}, K2 {launches[1]}, "
              f"K3 {k3} (pooled form {pooled}); "
              f"peak mem {peak:.2f} GiB; card busy {busy / span:.1%} of the "
              f"profiled run ({len(kernels)} kernels); K1 on the model's "
              f"{w} px frames {k1_us:.1f} us/launch ({len(k1)} launches "
              f"profiled; bound {k1_bound_us:.1f} us); {flops / 1e15:.4f} "
              f"PFLOP counted ({flops / (s_n * n_free * b) / 1e9:.2f} GFLOP "
              f"per frame) -> bound {b_ms:.1f} ms at "
              f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s = {b_ms / ms:.1%}; "
              f"set-up + warm-up {setup_s:.1f} s")
        print_kernel_groups(f"[backbones full] {name}", kernels, busy,
                            KERNEL_GROUPS)
        print(f"[backbones full] {name} mean ssim "
              f"{out['ssim'].mean().item():.5f}  mean psnr "
              f"{out['psnr'].mean().item():.4f} dB  mean mse "
              f"{out['mse'].mean().item():.5f}")
        results[name] = dict(ms=ms, fps=frames / (ms / 1e3), k1_us=k1_us,
                             launches=launches[0], k3=k3)
        del fns, loaded, x, out, kernels
        torch.cuda.empty_cache()
    return results


def phase_backbones_train():
    """(b): the VGG-128 train step in bf16 at B 8, T 15, --remat."""
    import torch
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                             ssim_psnr_batch_images)
    from dvg_tpu_torch.train import init_train_state, make_train_step
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = False
    cfg = DVGConfig(**BB_TRAIN)
    t, b, w = cfg.seq_len_train, cfg.batch_size, cfg.image_width
    g = torch.Generator(device=CARD).manual_seed(6)
    x = torch.rand((t, b, w, w, 3), generator=g, device=CARD)
    # the work one step must do: counted at B 1 without remat (every conv
    # and GEMM is linear in B; the recomputation is not needed work)
    one = cfg.replace(batch_size=1, remat=False)
    flops = b * counted_flops(lambda: make_train_step(one)(
        init_train_state(one, device=CARD), x[:, :1]))
    state = init_train_state(cfg, device=CARD)
    n_params = sum(p.numel() for p in state.model.parameters())
    step = make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, m0 = step(state, x)
    loss0 = m0["loss"].item()
    warm_s = time.perf_counter() - t0
    ssim_psnr_batch_cyclic.launches = 0
    ssim_psnr_batch_images.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(TRAIN_STEPS):
        _, metrics = step(state, x)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = (ssim_psnr_batch_cyclic.launches,
                ssim_psnr_batch_images.launches)
    finite = all(torch.isfinite(v).item() for v in metrics.values())
    loss = metrics["loss"].item()
    nbytes = x.numel() * 4 + 7 * 4 * n_params
    b_ms, b_by = max((flops / BF16_FLOP_PER_S * 1e3, "operations"),
                     (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    print(f"[backbones train] VGG-128 bf16 C 3 B {b} T {t} g_dim "
          f"{cfg.g_dim} rnn {cfg.rnn_size}x{cfg.predictor_rnn_layers} M "
          f"{cfg.num_inducing_points} ft remat ({CARD_LINE}): {ms:.2f} "
          f"ms/step (events, {TRAIN_STEPS} pipelined steps; warm-up step "
          f"{warm_s:.2f} s); peak mem {peak:.2f} GiB; {n_params:,} params; "
          f"bound {b_ms:.2f} ms by {b_by} ({flops / 1e12:.3f} TFLOP counted "
          f"at B 1 x {b}) = {b_ms / ms:.1%}; loss step 0 {loss0:.4f} -> "
          f"after {TRAIN_STEPS} steps {loss:.4f}; finite {finite}; K1, K2 "
          f"launches {launches}")
    check(finite, "VGG-128: a train metric is not finite")
    check(launches == (0, 0), f"the train step launched K1/K2 {launches}")
    check(loss < loss0, f"VGG-128: the joint loss did not fall ({loss0} -> "
          f"{loss})")
    kernels, busy, span = device_kernels(lambda: step(state, x))
    print(f"[backbones train] VGG-128 profiled step: {len(kernels)} "
          f"kernels, device busy {busy:.1f} ms of a {span:.1f} ms span "
          f"({busy / span:.1%})")
    print_kernel_groups("[backbones train] VGG-128", kernels, busy,
                        TRAIN_GROUPS)
    del state, step, x
    torch.cuda.empty_cache()
    return ms


def phase_backbones_cli(tmp: str):
    """(c): the training CLI on VGG-128 for one short epoch, then the eval
    CLI on its checkpoint."""
    import torch
    from dvg_tpu_torch.checkpoint import load_checkpoint
    from dvg_tpu_torch.cli import train as train_cli
    tmp = Path(tmp)
    run, no_mnist = tmp / "bb_train_run", tmp / "bb_no_mnist"
    no_mnist.mkdir()
    t0 = time.perf_counter()
    check(train_cli.main([
        "--dataset", "smmnist", "--data_root", str(no_mnist),
        "--output_path", str(run), "--log_dir", str(run / "logs"),
        "--model", "vgg", "--image_width", "128", "--remat", "--dtype",
        "bfloat16", "--batch_size", "8", "--epoch_size", str(BB_CLI_STEPS),
        "--niter", "1", "--ckpt_every", "1"]) == 0, "VGG-128 train CLI")
    train_s = time.perf_counter() - t0
    recs = [r for r in read_records(run / "logs") if r["kind"] == "epoch"]
    cfg, _, payload = load_checkpoint(str(run))
    files = sorted(p.name for p in run.iterdir())
    print(f"[backbones cli] train --model vgg --image_width 128 --remat "
          f"--dtype bfloat16, smmnist C 1 B 8, {BB_CLI_STEPS} steps: "
          f"{train_s:.2f} s wall, step {recs[0]['step_s'] * 1e3:.1f} ms, "
          f"epoch_mse {recs[0]['epoch_mse']:.5f}; checkpoint {cfg.model} "
          f"{cfg.image_width} px C {cfg.channels} step "
          f"{int(payload['step'])}; files {files}")
    check(cfg.model == "vgg" and cfg.image_width == 128
          and cfg.channels == 1, f"checkpoint config {cfg}")
    check(int(payload["step"]) == BB_CLI_STEPS and len(recs) == 1
          and math.isfinite(recs[0]["epoch_mse"]),
          f"train CLI records {recs}, step {int(payload['step'])}")
    check({"model.ckpt", "sample_0.png", "sample_0.gif"} <= set(files),
          f"train CLI files {files}")
    logs = tmp / "bb_eval"
    wall, per_call, clips, best, k2_cli, peak = cli_run(
        str(run), str(no_mnist), logs, "--dtype", "bfloat16",
        "--override_batch_size", "8")
    gen = cfg.generation_override()
    n_free = gen.n_eval - gen.n_past
    worst, k2 = rescore_best(logs, clips, best, gen.n_past, 100)
    tol = BB_CLI_TOL
    print(f"[backbones cli] eval CLI on it, bf16 B 8 ({CARD_LINE}): "
          f"{wall:.2f} s wall for {CLI_BATCHES} batches, K1 launches per "
          f"batch {per_call} on {tuple(clips[0].shape[2:])} frames, peak "
          f"{peak:.2f} GiB; the re-rolled best-SSIM column of its "
          f"{len(best)} GIFs scored by K2 ({k2} launches) vs the npz: "
          f"max|dssim| {worst[0]:.3e}  max|dpsnr| {worst[1]:.3e} dB  (tol "
          f"{tol})")
    check(tuple(clips[0].shape[2:]) == (128, 128, 1),
          f"eval frames {tuple(clips[0].shape)}")
    check(per_call == [n_free] * CLI_BATCHES,
          f"K1 launches per batch {per_call}, want {n_free}")
    check(k2_cli == 0 and k2 == len(best) == 8 * CLI_BATCHES,
          f"K2 launches: {k2_cli} in the CLI, {k2} re-scoring {len(best)} "
          "GIFs")
    check(worst[0] <= tol["ssim_atol"] and worst[1] <= tol["psnr_atol"],
          f"VGG-128: the GIF's best column is not the scored future: "
          f"{worst}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# [import]: a reference model.pth, BAIR TFRecords, the eval CLI (phase 13)
# ---------------------------------------------------------------------------

def write_reference_pth(cfg, path: str, seed: int) -> str:
    """A reference-schema model.pth (reference train.py:380-388) of cfg's
    backbone: reference-architecture modules built on the CPU from a
    seeded unit-gain port model with a trained-looking GP, written by the
    port's writer with an `opt` namespace of cfg's fields (the reference's
    has no num_inducing_points)."""
    import argparse
    from dvg_tpu_torch.convert import params_to_jax
    from dvg_tpu_torch.train import import_torch as IT
    model = with_trained_gp(unit_gain_model(cfg, "cpu"), seed=seed)
    params, stats = params_to_jax(model.state_dict(), cfg)
    enc, dec, fp = IT.reference_modules(params, stats, cfg)
    gp_sd, lik_sd = IT.gp_state_dicts_j2t(params["gp"], params["likelihood"])
    opt = argparse.Namespace(**{k: v for k, v in cfg.to_dict().items()
                                if k != "num_inducing_points"})
    IT.save_reference_style_checkpoint(path, enc, dec, fp, gp_sd, lik_sd, opt)
    return path


def port_posterior(pth: str, out: str, x, dev):
    """The port's import of `pth` built on `dev`, loaded there, and its f32
    posterior of the clip x → (frames on the CPU, import seconds, the
    imported checkpoint's path)."""
    import torch
    from dvg_tpu_torch.checkpoint import load_model
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    from dvg_tpu_torch.train.import_torch import import_checkpoint
    t0 = time.perf_counter()
    ckpt = import_checkpoint(pth, out, device=dev)
    import_s = time.perf_counter() - t0
    cfg, model = load_model(ckpt, device=dev)
    frames = make_rollout_fns(model, cfg).posterior(x, device=dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return frames.cpu(), import_s, ckpt


def reference_posterior(pth: str, x, dev):
    """The reference's make_gifs posterior loop (reference
    generate_frames.py:111-134) over the modules unpickled from `pth`, on
    `dev` in NCHW plain torch, with the GP mean from the port's
    models/gp.py (as tests/test_full_model_parity.py:161-205 runs it on the
    CPU) → frames (T, B, H, W, C) on the CPU."""
    import torch
    from dvg_tpu_torch.models import gp as gp_mod
    from dvg_tpu_torch.train import import_torch as IT
    ck = IT.load_reference_checkpoint(pth)
    enc, dec, fp = (ck[k].to(dev).eval()
                    for k in ("encoder", "decoder", "frame_predictor"))
    d, n_past = ck["opt"].g_dim, ck["opt"].n_past
    gp_p, lik_p = IT.gp_state_dicts_t2j(ck["gp_layer"], ck["likelihood"], d)
    svgp = gp_mod.SVGP(d, gp_p["z"].shape[1])
    svgp.load_state_dict({k: torch.from_numpy(v) for k, v in gp_p.items()})
    lik = gp_mod.GaussianLikelihood(d)
    lik.load_state_dict({k: torch.from_numpy(v) for k, v in lik_p.items()})
    cache = gp_mod.build_cache(svgp.to(dev), lik.to(dev))
    x = torch.as_tensor(x, device=dev).permute(0, 1, 4, 2, 3)
    fp.hidden = fp.init_hidden(x.shape[1])
    gen, x_in, skip = [x[0]], x[0], None
    with torch.no_grad():
        for i in range(1, x.shape[0]):
            h, skips = enc(x_in)
            if i < n_past:
                skip = skips
                fp(h)
                x_in = x[i]
            else:
                mean, _ = gp_mod.cached_mean_var(cache, fp(h).T[..., None])
                x_in = dec([mean.T, skip])
            gen.append(x_in)
    return torch.stack(gen).permute(0, 1, 3, 4, 2).cpu()


def _varint(n: int) -> bytes:
    out = b""
    while True:
        low, n = n & 0x7F, n >> 7
        out += bytes([low | (0x80 if n else 0)])
        if not n:
            return out


def _pb(field: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def bair_example(aux1, main, actions, eef) -> bytes:
    """One softmotion30_44k tf.train.Example: per frame t the raw 64×64×3
    bytes of `{t}/image_aux1/encoded` and `{t}/image_main/encoded` (a
    BytesList each), a 4-float `{t}/action` and a 3-float
    `{t}/endeffector_pos` (packed FloatLists)."""
    import numpy as np
    entries = []
    for t in range(len(aux1)):
        for key, kind, raw in (
                (f"{t}/image_aux1/encoded", 1, aux1[t].tobytes()),
                (f"{t}/image_main/encoded", 1, main[t].tobytes()),
                (f"{t}/action", 2, np.asarray(actions[t], "<f4").tobytes()),
                (f"{t}/endeffector_pos", 2,
                 np.asarray(eef[t], "<f4").tobytes())):
            entries.append(_pb(1, _pb(1, key.encode())
                               + _pb(2, _pb(kind, _pb(1, raw)))))
    return _pb(1, b"".join(entries))


def write_bair_tfrecords(root: Path, seed: int):
    """BAIR_TRAJ trajectories of BAIR_FRAMES procedural 64×64 RGB frames (a
    lit gradient, a bouncing disc, sensor noise) as softmotion-style
    TFRecords, BAIR_PER_FILE records a file (zero CRCs: the reader skips
    them) under root/test → the image_aux1 frames (N, T, 64, 64, 3)
    uint8."""
    import struct
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(BAIR_FRAMES)[:, None, None]
    yy, xx = np.mgrid[0:64, 0:64]

    def bounce(p0, v):
        q = (p0 + v * t - 8) % 96
        return 8 + np.where(q < 48, q, 96 - q)

    frames = np.empty((BAIR_TRAJ, BAIR_FRAMES, 64, 64, 3), np.uint8)
    for k in range(BAIR_TRAJ):
        bg = rng.uniform(40, 200, 3) + rng.uniform(-1, 1, 3) * (
            yy[..., None] - 32)
        disc = ((yy - bounce(rng.uniform(8, 56), rng.uniform(-3, 3))) ** 2
                + (xx - bounce(rng.uniform(8, 56), rng.uniform(-3, 3))) ** 2
                < rng.uniform(5, 10) ** 2)
        img = np.where(disc[..., None], rng.uniform(0, 255, 3), bg)
        frames[k] = np.clip(img + rng.normal(0, 4, img.shape), 0, 255)
    src = root / "test"
    src.mkdir(parents=True)
    for i in range(0, BAIR_TRAJ, BAIR_PER_FILE):
        blob = b""
        for k in range(i, min(i + BAIR_PER_FILE, BAIR_TRAJ)):
            rec = bair_example(frames[k], frames[k][:, ::-1],
                               rng.normal(size=(BAIR_FRAMES, 4)),
                               rng.normal(size=(BAIR_FRAMES, 3)))
            blob += struct.pack("<Q", len(rec)) + bytes(4) + rec + bytes(4)
        (src / f"traj_{i:05d}_to_{i + BAIR_PER_FILE - 1:05d}.tfrecords"
         ).write_bytes(blob)
    return frames


def phase_import(tmp: str):
    """Phase 13 (module docstring)."""
    import os
    import numpy as np
    import torch
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.data import convert, frames as frames_mod
    from dvg_tpu_torch.runtime import fastload
    tmp = Path(tmp) / "import"
    tmp.mkdir()
    torch.backends.cudnn.benchmark = False
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. tiny, each backbone: the port's import on the card against the
    # unpickled reference modules on the card
    for name, kw in IMPORT_BACKBONES:
        cfg = DVGConfig(**dict(IMPORT_TINY, **kw))
        w = cfg.image_width
        pth = write_reference_pth(cfg, str(tmp / f"{name}.pth"), seed=2)
        x = np.random.RandomState(1).rand(cfg.n_eval, cfg.batch_size, w, w,
                                          3).astype(np.float32)
        got, import_s, _ = port_posterior(pth, str(tmp / name), x, CARD)
        ref = reference_posterior(pth, x, CARD)
        err = frames_err(got, ref)
        free = got[cfg.n_past:]
        print(f"[import] tiny {name}: .pth {os.path.getsize(pth) / 1e6:.1f} "
              f"MB imported on the card in {import_s:.2f} s; f32 posterior "
              f"{tuple(got.shape)} vs the reference loop over the unpickled "
              f"modules on the card: max|dframe| {err:.3e} (atol "
              f"{FRAME_ATOL}); free frames' range {free.min():.3f}.."
              f"{free.max():.3f}")
        check(bool(torch.isfinite(got).all()), f"{name}: frames not finite")
        check(err <= FRAME_ATOL, f"{name}: imported posterior vs the "
              f"reference loop: {err}")
        check(float(free.max() - free.min()) > 0.1,
              f"{name}: the free frames are flat")

    # 2. full width: DCGAN-64 at the bench geometry, C 3, B 50
    cfg = DVGConfig(**IMPORT_FULL)
    pth = write_reference_pth(cfg, str(tmp / "dcgan64_full.pth"), seed=3)
    x = np.random.RandomState(2).rand(cfg.n_eval, cfg.batch_size, 64, 64,
                                      3).astype(np.float32)
    got, import_s, ckpt = port_posterior(pth, str(tmp / "full"), x, CARD)
    ref = reference_posterior(pth, x, CARD)
    err = frames_err(got, ref)
    print(f"[import] full DCGAN-64 C 3 g_dim 90 rnn 256x2 M 40: .pth "
          f"{os.path.getsize(pth) / 1e6:.1f} MB -> model.ckpt "
          f"{os.path.getsize(ckpt) / 1e6:.1f} MB, import_checkpoint "
          f"{import_s:.2f} s (host, TrainState built on the card); f32 "
          f"posterior B {cfg.batch_size} n_eval {cfg.n_eval} vs the "
          f"reference loop: max|dframe| {err:.3e} (atol {FRAME_ATOL})")
    check(err <= FRAME_ATOL, f"full-width imported posterior: {err}")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32

    # 3. data: TFRecords -> convert_bair -> decode
    raw, root = tmp / "softmotion30_44k", tmp / "bair"
    t0 = time.perf_counter()
    want = write_bair_tfrecords(raw, seed=4)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = convert.convert_bair(str(raw), str(root), split="test")
    conv_s = time.perf_counter() - t0
    ds = frames_mod.BAIR(train=False, data_root=str(root),
                         seq_len=BAIR_FRAMES)
    order = [int(Path(d).parent.name[len("traj_"):]) * BAIR_PER_FILE
             + int(Path(d).name) for d in ds.dirs]
    paths = [os.path.join(d, f"{t}.png") for d in ds.dirs
             for t in range(BAIR_FRAMES)]
    n_frames = len(paths)
    records = list((raw / "test").iterdir())
    print(f"[import] {n} trajectories x {BAIR_FRAMES} frames written as "
          f"{len(records)} TFRecord files "
          f"({sum(p.stat().st_size for p in records) / 1e6:.1f} MB) in "
          f"{write_s:.2f} s; convert_bair {conv_s:.2f} s = "
          f"{conv_s / n_frames * 1e3:.3f} ms/frame")
    check(n == BAIR_TRAJ and len(ds.dirs) == BAIR_TRAJ and sorted(order)
          == list(range(BAIR_TRAJ)), f"converted {n} trajectories, "
          f"{len(ds.dirs)} dirs")
    t0 = time.perf_counter()
    numpy_dec = np.stack([frames_mod._read_png(p, 64, False) for p in paths])
    numpy_s = time.perf_counter() - t0
    exact = want[order].reshape(numpy_dec.shape).astype(np.float32) / 255.0
    d_src = float(np.abs(numpy_dec - exact).max())
    print(f"[import] numpy decoder: {n_frames / numpy_s:,.0f} frames/s "
          f"(host, one thread); converted frames vs the written ones "
          f"max|d| {d_src:.3e}")
    check(d_src == 0.0, f"converted frames differ from the written: {d_src}")
    if fastload.is_available():
        t0 = time.perf_counter()
        native_dec = fastload.decode_batch(paths, 64, 64, 3)
        native_s = time.perf_counter() - t0
        d_dec = float(np.abs(native_dec - numpy_dec).max())
        print(f"[import] native decoder: {n_frames / native_s:,.0f} frames/s"
              f" (host, {os.cpu_count()} threads); vs numpy max|d| "
              f"{d_dec:.3e} (atol {DECODER_ATOL:.4f})")
        check(d_dec <= DECODER_ATOL, f"native vs numpy decoder: {d_dec}")
    else:
        print(f"[import] native decoder cannot be built on this machine, "
              f"comparison skipped: {fastload.status()}")
    del numpy_dec, exact

    # 4. the eval CLI on the imported checkpoint and the converted data
    logs = tmp / "eval"
    wall, per_call, clips, best, k2_cli, peak = cli_run(
        str(Path(ckpt).parent), str(root), logs, "--dtype", "bfloat16",
        "--override_n_eval", str(BAIR_FRAMES), "--override_batch_size",
        str(cfg.batch_size), "--nsample", "100", dataset="bair")
    n_free = BAIR_FRAMES - cfg.n_past
    b = cfg.batch_size
    d_clip = max(float((c.float().cpu() - torch.from_numpy(
        want[order[i * b:(i + 1) * b]].transpose(1, 0, 2, 3, 4)
        .astype(np.float32) / 255.0)).abs().max())
        for i, c in enumerate(clips))
    worst, k2 = rescore_best(logs, clips, best, cfg.n_past, 100)
    recs = read_records(logs)
    times = [r for r in recs if r["kind"] == "time"]
    loaded = [m for m in ("PIL", "imageio") if m in sys.modules]
    tol = CLI_TOL["bfloat16"]
    decoder = "native" if fastload.is_available() else "numpy"
    print(f"[import] eval CLI bf16 on the imported checkpoint, --dataset "
          f"bair from the converted tree ({decoder} decoder: "
          f"{fastload.status()}), S 100 B "
          f"{b} n_past {cfg.n_past} n_eval {BAIR_FRAMES}, {CARD_LINE}: "
          f"{wall:.2f} s wall for {CLI_BATCHES} batches, K1 launches per "
          f"batch {per_call}, peak {peak:.2f} GiB; its clips vs the written "
          f"frames max|d| {d_clip:.3e}")
    for r in times:
        print(f"[import] batch {r['step']} s: assembly {r['batch_s']:.4f}  "
              f"posterior {r['posterior_s']:.3f}  diverse_metrics "
              f"{r['metrics_s']:.3f} ({100 * n_free * b / r['metrics_s']:,.0f}"
              f" frames/s)  re-roll {r['reroll_s']:.3f}  10 GIFs "
              f"{r['gifs_s']:.3f}")
    print(f"[import] best-SSIM column of its {len(best)} GIFs re-scored by "
          f"K2 ({k2} launches) vs the npz: max|dssim| {worst[0]:.3e}  "
          f"max|dpsnr| {worst[1]:.3e} dB  (tol {tol}); PIL/imageio "
          f"imported: {loaded or 'none'}")
    check(per_call == [n_free] * CLI_BATCHES,
          f"K1 launches per batch {per_call}, want {n_free}")
    check(d_clip <= DECODER_ATOL, f"the CLI's clips differ from the "
          f"written frames: {d_clip}")
    check(k2_cli == 0 and k2 == len(best) == 10 * CLI_BATCHES,
          f"K2 launches: {k2_cli} in the CLI, {k2} re-scoring {len(best)}")
    check(worst[0] <= tol["ssim_atol"] and worst[1] <= tol["psnr_atol"],
          f"the GIF's best column is not the scored future: {worst}")
    check(not loaded, f"the import phase imported {loaded}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# [dist]: the parallel layer on one card (phase 14)
# ---------------------------------------------------------------------------

def _metrics_list(m):
    return [m[k] for k in METRICS]


def _dist_rank(rank: int, n: int, port: int, tmp: str, job: str) -> None:
    """One rank of phase 14: joins the group of `job` ("nccl1": NCCL, else
    gloo) over the DVG_* env on the card, runs DIST_JOBS[job] and saves its
    results to tmp/<job>_<rank>.pt. Its console goes to tmp/<job>_<rank>.log,
    which the phase prints if the rank fails."""
    import os
    import traceback
    log = open(Path(tmp) / f"{job}_{rank}.log", "w", buffering=1)
    sys.stdout = sys.stderr = log
    try:
        os.environ.update(DVG_COORDINATOR=f"localhost:{port}",
                          DVG_NUM_PROCESSES=str(n), DVG_PROCESS_ID=str(rank))
        sys.path.insert(0, str(ROOT))
        import torch
        import torch.distributed as dist
        from dvg_tpu_torch.parallel import distributed_init
        check(distributed_init(CARD, "nccl" if job == "nccl1" else "gloo"),
              "the DVG_* env did not start a group")
        res = DIST_JOBS[job](rank, n, Path(tmp))
        res["backend"] = dist.get_backend()
        torch.save(res, Path(tmp) / f"{job}_{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        log.flush()


def _f32_exact():
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _tiny_eval_fns(spec, nsample: int):
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    from dvg_tpu_torch.models.dvg import DVGModel
    cfg = DVGConfig(**DIST_TINY_EVAL)
    model = DVGModel(cfg, device="cpu")
    model.load_state_dict(spec["eval_sd"])
    return make_rollout_fns(model.to(CARD), cfg.replace(nsample=nsample))


def _job_nccl1(rank, n, tmp):
    """(a): NCCL at world size 1: the tiny f64 step through the group path
    against the same step without a group, and the sharded eval on a
    ("sample", 1) mesh against the plain call."""
    import torch
    import torch.distributed as dist
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.ops.epilogue import conv_epilogue
    from dvg_tpu_torch.ops.ssim_cuda import ssim_psnr_batch_cyclic
    from dvg_tpu_torch.parallel import make_mesh, shard_diverse_metrics
    from dvg_tpu_torch.parallel import dryrun as D
    spec = torch.load(tmp / "dist_spec.pt", weights_only=False)
    _f32_exact()
    torch.backends.cudnn.deterministic = True
    cfg = DVGConfig(**TRAIN_TINY)
    dp = D.step_result(cfg, spec["train_sd"], spec["train_x"],
                       dist.group.WORLD, CARD)
    one = D.step_result(cfg, spec["train_sd"], spec["train_x"], None, CARD)
    dp.pop("state")
    one.pop("state")
    fns = _tiny_eval_fns(spec, DIST_TINY_EVAL["nsample"])
    sharded = shard_diverse_metrics(fns, make_mesh([("sample", 1)]))
    ssim_psnr_batch_cyclic.launches = conv_epilogue.launches = 0
    got = sharded(spec["x_eval"], seed=DIST_TINY_SEED, device=CARD)
    torch.cuda.synchronize()
    launches = ssim_psnr_batch_cyclic.launches
    k3 = conv_epilogue.launches
    plain = fns.diverse_metrics(spec["x_eval"], seed=DIST_TINY_SEED,
                                device=CARD)
    # metrics and gradients at 1e-12; the weights, BN statistics and Adam
    # moments after the update at phase 11a's 1e-9: the group path's
    # two-pass BN variance differs from torch.var_mean's in the last bits,
    # and Adam's first update lr·g/(|g| + 1e-8) turns such a difference in
    # a gradient near 0 into ~1e-11
    errs = D.step_errors(dp, one, DIST_NCCL_TOL)
    errs.update({k: v for k, v in D.step_errors(dp, one, DIST_F64_TOL).items()
                 if k in ("state", "moments")})
    return dict(step_errors=errs,
                eval_errs=max_errs(_metrics_list(got), _metrics_list(plain)),
                launches=launches, k3=k3)


def _timed_sharded(metrics, x, seed):
    """One sharded protocol after a barrier, K1's and K3's counts set to 0
    just before → (metrics on the CPU, ms by CUDA events, K1 launches, peak
    GiB, K3 launches)."""
    import torch
    import torch.distributed as dist
    from dvg_tpu_torch.ops.epilogue import conv_epilogue
    from dvg_tpu_torch.ops.ssim_cuda import ssim_psnr_batch_cyclic
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ssim_psnr_batch_cyclic.launches = conv_epilogue.launches = 0
    start.record()
    out = metrics(x, seed=seed, device=CARD)
    end.record()
    torch.cuda.synchronize()
    return ({k: v.cpu() for k, v in out.items()}, start.elapsed_time(end),
            ssim_psnr_batch_cyclic.launches,
            torch.cuda.max_memory_allocated() / 2**30,
            conv_epilogue.launches)


def _job_gloo2(rank, n, tmp):
    """(b) and (d): two ranks on the one card over gloo."""
    import torch
    import torch.distributed as dist
    from dvg_tpu_torch.checkpoint import load_checkpoint, load_model
    from dvg_tpu_torch.cli import generate as gen_cli
    from dvg_tpu_torch.cli import train as train_cli
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    from dvg_tpu_torch.parallel import make_mesh, shard_diverse_metrics
    from dvg_tpu_torch.parallel import dryrun as D
    spec = torch.load(tmp / "dist_spec.pt", weights_only=False)
    _f32_exact()
    res = {}
    # (b1) the tiny f64 step, 2 × B 4, against one process on B 8
    cfg = DVGConfig(**TRAIN_TINY)
    b = cfg.batch_size // n
    dp = D.step_result(cfg, spec["train_sd"],
                       spec["train_x"][:, rank * b:(rank + 1) * b],
                       dist.group.WORLD, CARD)
    dp.pop("state")
    if rank == 0:
        one = D.step_result(cfg, spec["train_sd"], spec["train_x"], None,
                            CARD)
        one.pop("state")
        res["step_errors"] = D.step_errors(dp, one, DIST_F64_TOL)
    # (b2) the full-width sample-sharded protocol from the phase-4
    # checkpoint (every rank reads rank 0's bytes), f32 then bf16
    saved, model = load_model(spec["ckpt"], device=CARD)
    x = spec["x"].to(CARD)
    mesh = make_mesh([("sample", n)])
    for dtype in ("float32", "bfloat16"):
        local = make_rollout_fns(model, saved.replace(
            dtype=dtype, nsample=saved.nsample // n))
        metrics = shard_diverse_metrics(local, mesh)
        if dtype == "bfloat16":
            metrics(x, seed=2, device=CARD)              # warm-up
        res[dtype] = _timed_sharded(metrics, x, MAIN_SEED)
    del x, model
    torch.cuda.empty_cache()
    # (d) the training CLI --mesh 2 (2 epochs, then a resumed third), each
    # rank with its own output directory, then the eval CLI --mesh_samples 2
    # on rank 0's checkpoint
    root = tmp / "dist_cli"
    own = root / f"rank{rank}"
    args = ["--dataset", "smmnist", "--data_root", str(root / "no_mnist"),
            "--output_path", str(own / "run"),
            "--log_dir", str(own / "run" / "logs"),
            "--epoch_size", str(DIST_EPOCH), "--ckpt_every", "1",
            "--dtype", "bfloat16", "--mesh", "2", "--dist_backend", "gloo"]
    t0 = time.perf_counter()
    check(train_cli.main(args + ["--niter", "2"]) == 0, "train CLI failed")
    res["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(train_cli.main(args + ["--niter", "3", "--resume"]) == 0,
          "train CLI --resume failed")
    res["resume_s"] = time.perf_counter() - t0
    wall, per_call, clips, best, k2, peak = cli_run(
        str(own / "run"), str(root / "no_mnist"), own / "eval",
        "--num_batches", str(DIST_CLI_BATCHES), "--mesh_samples", "2",
        "--dist_backend", "gloo")
    res.update(cli_wall=wall, cli_per_call=per_call, cli_k2=k2,
               cli_peak=peak)
    trained = load_checkpoint(str(root / "rank0" / "run"), synced=False)[0]
    flags = gen_cli.build_parser().parse_args([])
    res["cli_free"] = (flags.override_n_eval or
                       trained.generation_override().n_eval) - trained.n_past
    if rank == 0:
        res["rescore"] = rescore_best(own / "eval", clips, best,
                                      trained.n_past, flags.nsample)
    return res


def _job_tiny_eval(rank, n, tmp):
    """(c): n ranks on the card over gloo: the tiny eval on dryrun's mesh
    for n (4: ("sample", 2) × ("data", 2); 2: ("sample", 2)), and the
    full_cov guard on it."""
    import torch
    from dvg_tpu_torch.ops.epilogue import conv_epilogue
    from dvg_tpu_torch.ops.ssim_cuda import ssim_psnr_batch_cyclic
    from dvg_tpu_torch.parallel import make_mesh, shard_diverse_metrics
    from dvg_tpu_torch.parallel.dryrun import mesh_axes
    spec = torch.load(tmp / "dist_spec.pt", weights_only=False)
    _f32_exact()
    axes = mesh_axes(n)
    local = _tiny_eval_fns(spec, DIST_TINY_EVAL["nsample"] // axes[0][1])
    mesh = make_mesh(axes)
    ssim_psnr_batch_cyclic.launches = conv_epilogue.launches = 0
    got = shard_diverse_metrics(local, mesh)(spec["x_eval"],
                                             seed=DIST_TINY_SEED, device=CARD)
    torch.cuda.synchronize()
    res = dict(metrics={k: v.cpu() for k, v in got.items()},
               launches=ssim_psnr_batch_cyclic.launches,
               k3=conv_epilogue.launches,
               coordinate=list(mesh.get_coordinate()), guard="no error")
    try:
        shard_diverse_metrics(local, mesh, full_cov=True)
    except ValueError as e:
        res["guard"] = str(e)
    return res


def dist_spec(ckpt=None, x_main=None) -> dict:
    """The tiny inputs of phase 14's jobs (seeded unit-gain weights with a
    trained-looking GP; clips from seeds) and the full-width ones given."""
    import numpy as np
    from dvg_tpu_torch.config import DVGConfig
    cfg_t = DVGConfig(**TRAIN_TINY)
    cfg_e = DVGConfig(**DIST_TINY_EVAL)
    return dict(
        ckpt=ckpt, x=x_main,
        train_sd=with_trained_gp(unit_gain_model(cfg_t, "cpu"),
                                 seed=2).state_dict(),
        train_x=np.random.RandomState(TRAIN_TINY_SEED).rand(
            cfg_t.seq_len_train, cfg_t.batch_size, 64, 64, 3),
        eval_sd=with_trained_gp(unit_gain_model(cfg_e, "cpu"),
                                seed=3).state_dict(),
        x_eval=np.random.RandomState(6).rand(
            cfg_e.n_eval, cfg_e.batch_size, 64, 64, 3).astype(np.float32))


DIST_JOBS = {"nccl1": _job_nccl1, "gloo2": _job_gloo2,
             "tiny_eval": _job_tiny_eval}


def dist_spawn(tmp: Path, job: str, n: int) -> list:
    """Run `job` on n ranks (the spec in tmp/dist_spec.pt) → each rank's
    results; a rank that fails fails the phase with the ends of the
    ranks' logs."""
    import torch
    from dvg_tpu_torch.parallel.dryrun import free_port, run_ranks
    try:
        run_ranks(_dist_rank, n, (free_port(), str(tmp), job),
                  DIST_TIMEOUT_S)
    except RuntimeError as e:
        logs = "\n".join(
            f"--- rank {r} ---\n" + "\n".join(
                (tmp / f"{job}_{r}.log").read_text().splitlines()[-30:])
            for r in range(n) if (tmp / f"{job}_{r}.log").exists())
        raise SmokeFailure(f"[dist] {job}: {e}\n{logs}") from None
    return [torch.load(tmp / f"{job}_{r}.pt", weights_only=False)
            for r in range(n)]


def phase_dist(tmp: str, ckpt: str, x_main, out_main) -> dict:
    """Phase 14 (module docstring). `x_main` and `out_main` are the main
    path's clip and bf16 metrics (phase 7), on the CPU. → K1's and K3's
    launches per rank on the sharded protocol and K2's re-scoring the
    sharded eval CLI's GIFs."""
    import torch
    from dvg_tpu_torch.checkpoint import load_model
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    tmp = Path(tmp) / "dist"
    (tmp / "dist_cli" / "no_mnist").mkdir(parents=True)
    cfg_e = DVGConfig(**DIST_TINY_EVAL)
    spec = dist_spec(ckpt, x_main)
    torch.save(spec, tmp / "dist_spec.pt")
    torch.cuda.empty_cache()

    def spawn(job, n):
        t0 = time.perf_counter()
        return dist_spawn(tmp, job, n), time.perf_counter() - t0

    # (a) NCCL, world 1
    (a,), a_s = spawn("nccl1", 1)
    print(f"[dist] (a) {a['backend']} world 1 on the card ({a_s:.1f} s with "
          f"start-up): tiny f64 step through the group path vs the same "
          f"step without a group, excess over {DIST_NCCL_TOL} (state and "
          f"moments {DIST_F64_TOL}): "
          f"{a['step_errors']}; the ('sample', 1)-sharded tiny f32 eval vs "
          f"the plain call max|d| {a['eval_errs'][3]:.3e}, K1 launches "
          f"{a['launches']}, K3 {a['k3']}")
    n_free_tiny = cfg_e.n_eval - cfg_e.n_past
    k3_tiny = k3_per_call(cfg_e)
    check(a["backend"] == "nccl", f"(a) ran on {a['backend']}")
    check(max(a["step_errors"].values()) <= 0,
          f"(a) NCCL step vs no group: {a['step_errors']}")
    check(a["eval_errs"][3] <= 1e-12, f"(a) eval: {a['eval_errs']}")
    check(a["launches"] == n_free_tiny, f"(a) K1 launches {a['launches']}")
    check(a["k3"] == k3_tiny, f"(a) K3 launches {a['k3']}, want {k3_tiny}")

    # the one-process references on the card: the full-width f32 protocol
    # (bf16: the main path's own run), the tiny eval
    _f32_exact()
    torch.backends.cudnn.benchmark = False
    saved, model = load_model(ckpt, device=CARD)
    ref32 = make_rollout_fns(model, saved.replace(dtype="float32")
                             ).diverse_metrics(x_main.to(CARD),
                                               seed=MAIN_SEED, device=CARD)
    ref32 = {k: v.cpu() for k, v in ref32.items()}
    del model
    ref_tiny = {k: v.cpu() for k, v in _tiny_eval_fns(
        spec, cfg_e.nsample).diverse_metrics(
            spec["x_eval"], seed=DIST_TINY_SEED, device=CARD).items()}
    torch.cuda.empty_cache()

    # (b) and (d): two ranks sharing the card over gloo
    b2, b_s = spawn("gloo2", 2)
    s_n, b, n_free = saved.nsample, saved.batch_size, saved.n_eval - \
        saved.n_past
    e32 = max(max_errs(_metrics_list(r["float32"][0]), _metrics_list(ref32))
              for r in b2)
    e16 = max(max_errs(_metrics_list(r["bfloat16"][0]),
                       _metrics_list(out_main)) for r in b2)
    ms = [r["bfloat16"][1] for r in b2]
    launches = [r[dt][2] for dt in ("float32", "bfloat16") for r in b2]
    k3 = [r[dt][4] for dt in ("float32", "bfloat16") for r in b2]
    print(f"[dist] (b) gloo, 2 ranks on one card ({b_s:.1f} s with start-up "
          f"and (d)); tiny f64 step 2 x B 4 vs one process on B 8, excess "
          f"over {DIST_F64_TOL}: {b2[0]['step_errors']}")
    print(f"[dist] (b) DCGAN-64 sample-sharded S {s_n // 2} per rank, B {b}, "
          f"n_past {saved.n_past}, n_eval {saved.n_eval}, {CARD_LINE}: f32 "
          f"vs one process (S {s_n}) max|dssim| {e32[0]:.3e} max|dpsnr| "
          f"{e32[1]:.3e} dB mse rel {e32[2]:.3e} (tol {DIST_F32_TOL}); K1 "
          f"launches per rank f32, bf16 {launches}, K3 {k3}")
    print(f"[dist] (b) bf16 ms per rank {[round(m, 1) for m in ms]} (events "
          f"around the sharded call, all-gather included), "
          f"{s_n * n_free * b / (max(ms) / 1e3):,.0f} frames/s of the pair; "
          f"peak GiB per rank {[round(r['bfloat16'][3], 2) for r in b2]}; "
          f"drift from the one-process bf16 run (phase 7) max|dssim| "
          f"{e16[0]:.3e} max|dpsnr| {e16[1]:.3e} dB mse rel {e16[2]:.3e} "
          f"(band {DIST_BF16_TOL}). Two ranks share one card: not a speedup")
    check(max(b2[0]["step_errors"].values()) <= 0,
          f"(b) 2-rank step vs one process: {b2[0]['step_errors']}")
    check(within(e32, DIST_F32_TOL), f"(b) f32 sharded vs one process: "
          f"{e32}")
    check(within(e16, DIST_BF16_TOL), f"(b) bf16 drift {e16}")
    check(launches == [n_free] * 4, f"(b) K1 launches per rank {launches}")
    check(k3 == [k3_per_call(saved)] * 4, f"(b) K3 launches per rank {k3}, "
          f"want {k3_per_call(saved)}")
    for r in b2:
        for k, v in r["bfloat16"][0].items():
            check(tuple(v.shape) == (s_n, n_free, b) and
                  bool(torch.isfinite(v).all()), f"(b) {k} {v.shape}")

    # (d) the CLIs' results
    root = tmp / "dist_cli"
    recs = read_records(root / "rank0" / "run" / "logs")
    epochs = [r for r in recs if r["kind"] == "epoch"]
    files = sorted(p.name for p in (root / "rank0" / "run").iterdir())
    cli_free = b2[0]["cli_free"]
    worst, k2 = b2[0]["rescore"]
    for r in epochs:
        print(f"[dist] (d) train CLI --mesh 2 --dist_backend gloo, bf16 "
              f"smmnist C 1, B 50 (25 per rank), T 15: epoch {r['step']} "
              f"{r['step_s'] * DIST_EPOCH:.2f} s, {r['step_s'] * 1e3:.1f} "
              f"ms/step (two ranks sharing one card: not a speedup; the "
              f"gloo all-reduces are in it), epoch_mse {r['epoch_mse']:.5f}")
    print(f"[dist] (d) --niter 2 {b2[0]['train_s']:.1f} s, --resume --niter "
          f"3 {b2[0]['resume_s']:.1f} s wall; rank 0's files {files}; rank 1 "
          f"wrote nothing: {not (root / 'rank1').exists()}; eval CLI "
          f"--mesh_samples 2: {b2[0]['cli_wall']:.1f} s wall for "
          f"{DIST_CLI_BATCHES} batch, K1 launches per batch per rank "
          f"{[r['cli_per_call'] for r in b2]}, peak GiB per rank "
          f"{[round(r['cli_peak'], 2) for r in b2]}; rank 0's GIFs' best "
          f"column re-scored by K2 ({k2} launches) vs the npz max|dssim| "
          f"{worst[0]:.3e} max|dpsnr| {worst[1]:.3e} dB (tol "
          f"{CLI_TOL['float32']})")
    check([r["step"] for r in epochs] == [0, 1, 2] and
          all(math.isfinite(r["epoch_mse"]) for r in epochs),
          f"(d) epoch records {epochs}")
    check({"model.ckpt", "sample_2.gif", "logs"} <= set(files),
          f"(d) files {files}")
    check(not (root / "rank1").exists(), "(d) rank 1 wrote files")
    check(all(r["cli_per_call"] == [cli_free] * DIST_CLI_BATCHES
              for r in b2),
          f"(d) K1 launches per batch {[r['cli_per_call'] for r in b2]}")
    check(worst[0] <= CLI_TOL["float32"]["ssim_atol"] and
          worst[1] <= CLI_TOL["float32"]["psnr_atol"],
          f"(d) the GIF's best column is not the scored future: {worst}")

    # (c) four ranks: the 2-D mesh and the full_cov guard
    c4, c_s = spawn("tiny_eval", 4)
    ec = max(max_errs(_metrics_list(r["metrics"]), _metrics_list(ref_tiny))
             for r in c4)
    print(f"[dist] (c) gloo, 4 ranks on one card ({c_s:.1f} s with start-up):"
          f" ('sample', 2) x ('data', 2) tiny f32 eval, coordinates "
          f"{[r['coordinate'] for r in c4]}, vs one process max|dssim| "
          f"{ec[0]:.3e} max|dpsnr| {ec[1]:.3e} dB mse rel {ec[2]:.3e}; K1 "
          f"launches per rank {[r['launches'] for r in c4]}, K3 "
          f"{[r['k3'] for r in c4]}; full_cov "
          f"guard: {c4[0]['guard'][:60]}...")
    check(within(ec, DIST_F32_TOL), f"(c) 2-D eval vs one process: {ec}")
    check([r["coordinate"] for r in c4] == [[0, 0], [0, 1], [1, 0], [1, 1]],
          "(c) mesh coordinates")
    check(all(r["launches"] == n_free_tiny for r in c4),
          "(c) K1 launches per rank")
    check(all(r["k3"] == k3_tiny for r in c4),
          f"(c) K3 launches per rank, want {k3_tiny}")
    check(all("full_cov" in r["guard"] for r in c4), "(c) full_cov guard")
    return dict(k1=[r["bfloat16"][2] for r in b2], k2=k2,
                k3=[r["bfloat16"][4] for r in b2])

def _serve_job(rank, n, tmp):
    """Phase 15's sharded check: this rank's block of the ("sample", 2)
    artifact, gathered on every rank."""
    import torch
    from dvg_tpu_torch.ops.epilogue import conv_epilogue
    from dvg_tpu_torch.ops.ssim_cuda import ssim_psnr_batch_cyclic
    from dvg_tpu_torch.serve import load_serving
    _f32_exact()
    torch.backends.cudnn.benchmark = False
    served = load_serving(str(tmp / "sharded.pt2"))
    x = torch.load(tmp / "x_cut.pt")
    ssim_psnr_batch_cyclic.launches = conv_epilogue.launches = 0
    out = served(x, MAIN_SEED)
    torch.cuda.synchronize()
    return dict(metrics={k: v.cpu() for k, v in out.items()},
                launches=ssim_psnr_batch_cyclic.launches,
                k3=conv_epilogue.launches, modules=_model_modules())


DIST_JOBS["serve2"] = _serve_job


def _model_modules() -> list:
    """The modules of the port's model and generation code, and of JAX,
    that this process imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] == "jax" or
                  m.startswith(("dvg_tpu_torch.models",
                                "dvg_tpu_torch.generate", "dvg_tpu.")))


def _cpu(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return type(tree)(_cpu(v) for v in tree)


def _entry_call(fn, entry: str, x):
    """One call of an entry (artifact or live) on the clip x: posterior
    takes no seed."""
    if entry == "posterior":
        return lambda: fn(x)
    seed = SERVE_TRIGGER_SEED if entry == "gp_trigger" else MAIN_SEED
    return lambda: fn(x, seed=seed)


def _serve_calls(call) -> dict:
    """A warm-up call, SERVE_REPS calls timed by CUDA events with K1's,
    K2's and K3's counts set to 0 just before and read just after, then one
    call profiled → the output, ms per call, K1's and K3's launches per
    call, K2's in all, K1's µs per launch and the card's busy share."""
    import torch
    from dvg_tpu_torch.ops.epilogue import conv_epilogue
    from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                             ssim_psnr_batch_images)
    call()
    ssim_psnr_batch_cyclic.launches = ssim_psnr_batch_images.launches = 0
    conv_epilogue.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(SERVE_REPS):
        out = call()
    end.record()
    torch.cuda.synchronize()
    k1, k2 = ssim_psnr_batch_cyclic.launches, ssim_psnr_batch_images.launches
    k3 = conv_epilogue.launches
    kernels, busy, span = device_kernels(call)
    us = [e.time_range.elapsed_us() for e in kernels
          if "ssim_kernel" in e.name]
    return dict(out=_cpu(out), ms=start.elapsed_time(end) / SERVE_REPS,
                k1=k1 / SERVE_REPS, k2=k2, k1_us=sum(us) / max(len(us), 1),
                busy=busy / span, k3=k3 / SERVE_REPS)


def _await(path: Path) -> None:
    while not path.exists():
        time.sleep(0.2)


def _serve_artifacts(tmp: str) -> None:
    """Phase 15's artifact side, in a fresh process with nothing of the
    model or generation code: loads each entry's artifact once its export
    has written the sidecar (which comes last), timing each load; then,
    once the live side has saved its results (so no two timings overlap),
    calls each through _serve_calls. Saves tmp/artifacts.pt."""
    import torch
    sys.path.insert(0, str(ROOT))
    tmp = Path(tmp)
    torch.backends.cudnn.benchmark = False
    from dvg_tpu_torch.serve import load_serving
    x = torch.load(tmp / "x.pt").to(CARD)
    fns, load_s = {}, {}
    for e in SERVE_ENTRIES:
        _await(tmp / f"{e}.pt2.json")
        t0 = time.perf_counter()
        fns[e] = load_serving(str(tmp / f"{e}.pt2"))
        load_s[e] = time.perf_counter() - t0
    modules = _model_modules()
    _await(tmp / "live.pt")
    torch.save(dict(load_s=load_s, modules=modules, calls={
        e: _serve_calls(_entry_call(fns[e], e, x)) for e in SERVE_ENTRIES}),
        tmp / "artifacts.pt")


def _serve_live(tmp: str, ckpt: str, trig_ckpt: str) -> None:
    """Phase 15's live side, in a fresh process: each entry of
    make_rollout_fns on its checkpoint through _serve_calls, then in f32
    at the cut depth the diverse_metrics that the sharded artifact is held
    to. Saves tmp/live.pt."""
    import torch
    sys.path.insert(0, str(ROOT))
    tmp = Path(tmp)
    torch.backends.cudnn.benchmark = False
    from dvg_tpu_torch.checkpoint import load_model
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    x = torch.load(tmp / "x.pt").to(CARD)
    calls = {}
    for e in SERVE_ENTRIES:
        saved, model = load_model(trig_ckpt if e == "gp_trigger" else ckpt,
                                  device=CARD)
        calls[e] = _serve_calls(_entry_call(
            getattr(make_rollout_fns(model, saved), e), e, x))
    _f32_exact()
    saved, model = load_model(ckpt, device=CARD)
    fns = make_rollout_fns(model, saved.replace(
        dtype="float32", n_eval=SERVE_CUT, n_future=SERVE_CUT - saved.n_past))
    f32 = fns.diverse_metrics(torch.load(tmp / "x_cut.pt").to(CARD),
                              seed=MAIN_SEED)
    torch.save(dict(calls=calls, f32=_cpu(f32)), tmp / "live.pt")


def _serve_start(command: list, log: Path):
    """command started from the repo's root, its console to log, one
    thread each (the processes outnumber the cores)."""
    import os
    with log.open("w") as f:
        return subprocess.Popen(command, cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT,
                                env=dict(os.environ, OMP_NUM_THREADS="1"))


def _serve_wait(procs: dict, names, tmp: Path, deadline: float) -> None:
    """Until each process in `names` has exited 0. Any process of `procs`
    that fails, or the deadline passing, fails the phase with the end of
    its log."""
    while not all(procs[n].poll() == 0 for n in names):
        for name, p in procs.items():
            check(p.poll() in (None, 0), f"[serve] {name} failed (rc "
                  f"{p.poll()}):\n" + "\n".join(
                      (tmp / f"{name}.log").read_text().splitlines()[-30:]))
        check(time.monotonic() < deadline,
              f"[serve] {names} still running after {SERVE_TIMEOUT_S} s")
        time.sleep(0.2)


def phase_serve(tmp: str, ckpt: str, x_main) -> dict:
    """Phase 15 (module docstring). `x_main` is the main path's clip
    (phase 7), on the CPU. → K1's launches inside the diverse_metrics
    artifact's call and its µs per launch there; K2's launches per call of
    the three artifacts; K3's launches inside the diverse_metrics
    artifact's call."""
    import torch
    from dvg_tpu_torch.checkpoint import save_checkpoint
    from dvg_tpu_torch.config import DVGConfig
    tmp = Path(tmp) / "serve"
    tmp.mkdir()
    for name, v in (("x", x_main), ("x_cut", x_main[:SERVE_CUT])):
        torch.save(v.contiguous(), tmp / f"{name}.pt")
    # gp_trigger on unit-gain weights with a trained-looking GP: on the
    # init law's weights the GP's variance hardly moves, and every
    # decision sits on its threshold
    cfg = DVGConfig(**HEADLINE)
    trig_ckpt = save_checkpoint(str(tmp / "trigger_model"), cfg,
                                with_trained_gp(unit_gain_model(cfg, "cpu"),
                                                seed=3))
    sources = {"diverse_metrics": ckpt, "posterior": ckpt,
               "gp_trigger": trig_ckpt}
    python = sys.executable
    jobs = {e: [sources[e], str(tmp / f"{e}.pt2"), "--entry", e]
            for e in SERVE_ENTRIES}
    jobs["sharded"] = [ckpt, str(tmp / "sharded.pt2"), "--entry",
                       "diverse_metrics", "--mesh_samples", "2", "--dtype",
                       "float32", "--n_eval", str(SERVE_CUT)]
    procs = {}
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    t0 = time.perf_counter()
    try:
        for j, args in jobs.items():
            procs[f"export_{j}"] = _serve_start(
                [python, "-m", "dvg_tpu_torch.serve.export"] + args,
                tmp / f"export_{j}.log")
        procs["artifacts"] = _serve_start(
            [python, "-c", "import chip_smoke as S; "
             f"S._serve_artifacts({str(tmp)!r})"], tmp / "artifacts.log")
        _serve_wait(procs, ["export_sharded"], tmp, deadline)
        ranks = dist_spawn(tmp, "serve2", 2)
        _serve_wait(procs, [f"export_{e}" for e in SERVE_ENTRIES], tmp,
                    deadline)
        procs["live"] = _serve_start(
            [python, "-c", "import chip_smoke as S; "
             f"S._serve_live({str(tmp)!r}, {ckpt!r}, {trig_ckpt!r})"],
            tmp / "live.log")
        _serve_wait(procs, list(procs), tmp, deadline)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    art = torch.load(tmp / "artifacts.pt", weights_only=False)
    live = torch.load(tmp / "live.pt", weights_only=False)
    for j in jobs:
        line = [ln for ln in (tmp / f"export_{j}.log").read_text(
        ).splitlines() if ln.startswith("wrote ")][-1]
        side = json.loads(Path(jobs[j][1] + ".json").read_text())
        print(f"[serve] export {j}: {line.split(' ', 2)[2]} ({CARD_LINE}'s "
              f"host); program inputs {side['in_shapes']}, platforms "
              f"{side['platforms']}")
    print(f"[serve] one fresh process loads the three artifacts: "
          + ", ".join(f"{e} {s:.1f} s" for e, s in art["load_s"].items())
          + f" ({CARD_LINE}'s host); model, generation or JAX modules "
          f"imported: {art['modules'] or 'none'}")
    check(not art["modules"], f"[serve] the artifacts' process imported "
          f"{art['modules']}")
    print(f"[serve] the four exports side by side, the artifacts loaded as "
          f"their exports end, the sharded artifact on 2 ranks, then the "
          f"live side and the timings: {wall:.1f} s wall")

    s_n, b, n_free = cfg.nsample, cfg.batch_size, cfg.n_eval - cfg.n_past
    got, ref = art["calls"], live["calls"]
    dm = got["diverse_metrics"]
    e16 = max_errs(_metrics_list(dm["out"]),
                   _metrics_list(ref["diverse_metrics"]["out"]))
    post = (got["posterior"]["out"]
            - ref["posterior"]["out"]).abs().max().item()
    trig, trig_ref = got["gp_trigger"]["out"], ref["gp_trigger"]["out"]
    trig_frames = (trig[0] - trig_ref[0]).abs().max().item()
    same = torch.equal(trig[1]["triggers"], trig_ref[1]["triggers"])
    fired = int(trig_ref[1]["triggers"].sum())
    k2 = sum(got[e]["k2"] for e in SERVE_ENTRIES)
    print(f"[serve] DCGAN-64 bf16 S {s_n} B {b} n_eval {cfg.n_eval}, "
          f"cudnn.benchmark off on both sides, {CARD_LINE}: diverse_metrics "
          f"artifact K1 launches {dm['k1']:g} per call, K1 "
          f"{dm['k1_us']:.1f} us per launch inside the artifact "
          f"({ref['diverse_metrics']['k1_us']:.1f} live), device busy "
          f"{dm['busy']:.1%}; K2 launches in the three artifacts' timed "
          f"calls {k2}; vs the live entry max|dssim| {e16[0]:.3e} "
          f"max|dpsnr| {e16[1]:.3e} dB mse rel {e16[2]:.3e} (band "
          f"{SERVE_BF16_TOL}); posterior frames max|d| {post:.3e}, "
          f"gp_trigger (unit gain, trained-looking GP) frames max|d| "
          f"{trig_frames:.3e} (band {SERVE_BF16_FRAME_ATOL:.3e}), "
          f"{fired} of {trig_ref[1]['triggers'].numel()} decisions fire "
          f"live, all equal {same}")
    k3 = {e: (got[e]["k3"], ref[e]["k3"]) for e in SERVE_ENTRIES}
    print(f"[serve] K3 launches per call, artifact / live: "
          + ", ".join(f"{e} {a:g} / {l:g}" for e, (a, l) in k3.items()))
    for e in SERVE_ENTRIES:
        a_ms, l_ms = got[e]["ms"], ref[e]["ms"]
        print(f"[serve] {e}: artifact {a_ms:.1f} ms per call, live "
              f"{l_ms:.1f} ms (each side in its own fresh process, CUDA "
              f"events over {SERVE_REPS} calls after a warm-up, "
              f"{CARD_LINE}); artifact {a_ms / l_ms - 1:+.1%}; device busy "
              f"{got[e]['busy']:.1%} / {ref[e]['busy']:.1%}")
    check(dm["k1"] == n_free,
          f"the artifact launched K1 {dm['k1']} times per call, not {n_free}")
    check(got["posterior"]["k1"] == got["gp_trigger"]["k1"] == 0,
          "the posterior or gp_trigger artifact launched K1")
    check(k2 == 0, f"the artifacts launched K2 {k2} times")
    check(dm["k3"] == k3_per_call(cfg), f"the artifact launched K3 "
          f"{dm['k3']} times per call, not {k3_per_call(cfg)}")
    check(all(a == l > 0 for a, l in k3.values()),
          f"K3 launches per call, artifact / live: {k3}")
    check(within(e16, SERVE_BF16_TOL), f"bf16 artifact vs live: {e16}")
    check(post <= SERVE_BF16_FRAME_ATOL, f"posterior artifact vs live {post}")
    check(trig_frames <= SERVE_BF16_FRAME_ATOL,
          f"gp_trigger artifact's frames vs live {trig_frames}")
    check(same, "gp_trigger artifact decisions differ from the live run's")
    check(fired > 0, "no gp_trigger decision fires")
    check(tuple(trig[0].shape) == (cfg.n_eval, b) + tuple(x_main.shape[2:])
          and bool(torch.isfinite(trig[0]).all()), "gp_trigger frames")

    # f32 at the cut depth: the sharded artifact against the live entry
    e_shard = max(max_errs(_metrics_list(r["metrics"]),
                           _metrics_list(live["f32"])) for r in ranks)
    cut_free = SERVE_CUT - cfg.n_past
    print(f"[serve] f32 n_eval {SERVE_CUT}: ('sample', 2) artifact on 2 gloo "
          f"ranks sharing the card vs the live entry in one process "
          f"max|dssim| {e_shard[0]:.3e} max|dpsnr| {e_shard[1]:.3e} dB mse "
          f"rel {e_shard[2]:.3e} (tol {SERVE_F32_TOL}); K1 launches per rank "
          f"{[r['launches'] for r in ranks]}, K3 {[r['k3'] for r in ranks]}, "
          f"modules imported "
          f"{[r['modules'] or 'none' for r in ranks]}")
    check(within(e_shard, SERVE_F32_TOL), f"sharded vs live {e_shard}")
    check(all(r["launches"] == cut_free for r in ranks),
          "sharded K1 launches per rank")
    cut_k3 = k3_per_call(cfg.replace(n_eval=SERVE_CUT))
    check(all(r["k3"] == cut_k3 for r in ranks),
          f"sharded K3 launches per rank, want {cut_k3}")
    check(not any(r["modules"] for r in ranks), "a rank imported model code")
    return dict(k1=int(dm["k1"]), k1_us=dm["k1_us"], k2=k2 // SERVE_REPS,
                k3=int(dm["k3"]))


# ---------------------------------------------------------------------------
# [soak quick]: the training soak's CLI, and the kernels on trained
# weights (phase 16)
# ---------------------------------------------------------------------------

def trigger_vs(got: dict, ref: dict) -> dict:
    """Two gp_trigger runs' diagnostics (CPU tensors) on one clip. A row's
    trajectories part at its first differing decision, so the values are
    compared up to and including it: → the decisions, those on a shared
    trajectory, the values' max relative difference there (and in the
    warm-up), |value − threshold| of ref at each differing decision, and
    whether each such margin lies within the two runs' difference of it
    (no decision far from its threshold differs)."""
    import torch
    differ = got["triggers"] != ref["triggers"]                  # (T, B)
    steps = torch.arange(differ.shape[0])[:, None]
    first = torch.where(differ, steps, differ.shape[0]).amin(0)
    shared = steps <= first[None]
    rel = ((got["values"] - ref["values"]).abs()
           / ref["values"].abs().clamp(min=1e-30))
    warm = ((got["warmup_values"] - ref["warmup_values"]).abs()
            / ref["warmup_values"].abs().clamp(min=1e-30))
    m_ref = ref["values"] - ref["thresholds"]
    m_got = got["values"] - got["thresholds"]
    at = differ & shared
    return dict(decisions=differ.numel(), shared=int(shared.sum()),
                rel=max(rel[shared].max().item() if shared.any() else 0.0,
                        warm.max().item()),
                flips=m_ref[at].abs().tolist(),
                flip_within=bool((m_ref[at].abs()
                                  <= (m_got - m_ref)[at].abs()).all()))


def _steps(errs) -> str:
    """A per-free-step error list, every fifth step and the last."""
    keep = sorted(set(range(0, len(errs), 5)) | {len(errs) - 1})
    return " ".join(f"{t}:{errs[t]:.1e}" for t in keep)


def trained_checks(model_dir: str, tag: str) -> dict:
    """The checks of a trained checkpoint (model_dir/model.ckpt) on the
    card, on the soak's first test batch (the eval CLI's batch 0):

      * K1 and K2 against their plain versions on the model's predicted
        frames at the main path's shapes: the bf16 protocol's 100 futures
        of the batch's 50 clips at n_eval 105, K1 on every free step's
        (5000, 64, 64, 1) frames against the step's ground truth, K2 on
        the first 10 rows' sample-0 futures, a launch per row
        (TRAINED_TOL);
      * in f32 with TF32 off, card against the CPU over the clips' first
        TRAINED_CUT frames: `posterior` on TRAINED_ROWS rows within
        FRAME_ATOL, `diverse_metrics` (S TRAINED_S, seeded noise) within
        PATH_TOL, and `gp_trigger` on TRAINED_TRIGGER_ROWS rows with its
        values within 1e-4 relative on the trajectory both sides share and
        a decision differing only where the CPU's value lies within the
        two sides' difference of its threshold (`trigger_vs`). Each free
        step's error is printed. → the numbers."""
    import numpy as np
    import torch
    from dvg_tpu_torch.checkpoint import load_model
    from dvg_tpu_torch.data import Loader, load_dataset
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    from dvg_tpu_torch.ops import ssim, ssim_cuda
    saved, model = load_model(model_dir, device=CARD)
    cfg = saved.generation_override().replace(dtype="bfloat16",
                                              data_root="", **TRAINED_PROTOCOL)
    loader = Loader(load_dataset(cfg, seq_len=cfg.n_eval, split="test"),
                    cfg.batch_size, shuffle=False, seed=cfg.seed,
                    num_threads=1, device="cpu")
    try:
        x = loader.next_batch(0)
    finally:
        loader.stop()
    x = torch.as_tensor(x).float()
    xc = x.to(CARD)
    n_past, n_free = cfg.n_past, cfg.n_eval - cfg.n_past
    torch.backends.cudnn.benchmark = True
    frames = make_rollout_fns(model, cfg).diverse(xc, seed=cfg.seed * 1000,
                                                  device=CARD)
    frames = frames.to(torch.bfloat16)        # the rollout's bf16, exactly
    res = {"k1": [0.0] * 4, "k2": [0.0] * 4}
    for t in range(n_past, cfg.n_eval):
        gt = xc[t].contiguous()
        pred = frames[:, t].reshape((-1,) + tuple(gt.shape[1:])).contiguous()
        e = max_errs(ssim_cuda.ssim_psnr_batch_cyclic(gt, pred),
                     ssim.ssim_psnr_cyclic_plain(gt, pred))
        res["k1"] = [max(a, b) for a, b in zip(res["k1"], e)]
    for row in range(10):
        gt = xc[n_past:, row].contiguous()
        pred = frames[0, n_past:, row].contiguous()
        e = max_errs(ssim_cuda.ssim_psnr_batch_images(gt, pred),
                     ssim.ssim_psnr_images_plain(gt, pred))
        res["k2"] = [max(a, b) for a, b in zip(res["k2"], e)]
    spread = frames[:, -1].float().std(0).mean().item()
    del frames
    torch.cuda.empty_cache()
    print(f"[{tag}] K1 on the trained model's frames, {n_free} steps of "
          f"({cfg.nsample * cfg.batch_size}, 64, 64, {cfg.channels}) bf16 "
          f"vs plain: max|dssim| {res['k1'][0]:.3e} max|dpsnr| "
          f"{res['k1'][1]:.3e} dB mse rel {res['k1'][2]:.3e}; K2, 10 rows of "
          f"{n_free} pairs: {res['k2'][0]:.3e} / {res['k2'][1]:.3e} dB / "
          f"{res['k2'][2]:.3e} (tol {TRAINED_TOL}); futures' spread at the "
          f"last step {spread:.3e}")
    check(within(res["k1"], TRAINED_TOL), f"[{tag}] K1 vs plain {res['k1']}")
    check(within(res["k2"], TRAINED_TOL), f"[{tag}] K2 vs plain {res['k2']}")
    check(spread > 0, f"[{tag}] the trained model's futures do not differ")

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    _f32_exact()
    cpu_model = copy.deepcopy(model).cpu()
    small = cfg.replace(dtype="float32", nsample=TRAINED_S,
                        batch_size=TRAINED_ROWS, n_eval=TRAINED_CUT,
                        n_future=TRAINED_CUT - n_past)
    xs = x[:TRAINED_CUT, :TRAINED_ROWS]
    sides = (("cpu", cpu_model), (CARD, model))
    post = {d: make_rollout_fns(m, small).posterior(xs, device=d).cpu()
            for d, m in sides}
    post_steps = (post[CARD] - post["cpu"]).abs().amax(
        dim=(1, 2, 3, 4))[n_past:].tolist()
    res["posterior"] = max(post_steps)
    met = {d: {k: v.cpu() for k, v in make_rollout_fns(m, small)
               .diverse_metrics(xs, seed=MAIN_SEED, device=d).items()}
           for d, m in sides}
    res["diverse_metrics"] = max_errs([met[CARD][k] for k in METRICS],
                                      [met["cpu"][k] for k in METRICS])
    dm_steps = (met[CARD]["ssim"] - met["cpu"]["ssim"]).abs().amax(
        dim=(0, 2)).tolist()
    trig_cfg = small.replace(batch_size=TRAINED_TRIGGER_ROWS)
    xt = x[:TRAINED_CUT, :TRAINED_TRIGGER_ROWS]
    diag = {d: {k: v.cpu() for k, v in make_rollout_fns(m, trig_cfg)
                .gp_trigger(xt, seed=7, device=d)[1].items()}
            for d, m in sides}
    t = res["trigger"] = trigger_vs(diag[CARD], diag["cpu"])
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    e = res["diverse_metrics"]
    print(f"[{tag}] f32, TF32 off, card vs CPU, n_eval {TRAINED_CUT}: "
          f"posterior ({TRAINED_ROWS} rows) max|dframe| "
          f"{res['posterior']:.3e} (atol {FRAME_ATOL}), by free step "
          f"{_steps(post_steps)}; diverse_metrics (S {TRAINED_S}, "
          f"{TRAINED_ROWS} rows) max|dssim| {e[0]:.3e} max|dpsnr| "
          f"{e[1]:.3e} dB mse rel {e[2]:.3e} (tol {PATH_TOL}), |dssim| by "
          f"free step {_steps(dm_steps)}")
    print(f"[{tag}] f32 gp_trigger ({TRAINED_TRIGGER_ROWS} rows, "
          f"{t['decisions']} decisions): {int(diag['cpu']['triggers'].sum())}"
          f" fire on the CPU, {int(diag[CARD]['triggers'].sum())} on the "
          f"card; {t['shared']} decisions on a trajectory both sides share "
          f"(up to each row's first differing decision), values max rel d "
          f"{t['rel']:.3e} there (tol 1e-4); {len(t['flips'])} decisions "
          f"differ, at |value - threshold| "
          f"{[f'{m:.2e}' for m in t['flips']]}, each within the two sides' "
          f"difference of it {t['flip_within']}")
    check(res["posterior"] <= FRAME_ATOL,
          f"[{tag}] posterior card vs CPU {res['posterior']}")
    check(within(e, PATH_TOL), f"[{tag}] diverse_metrics card vs CPU {e}")
    check(t["rel"] <= 1e-4, f"[{tag}] gp_trigger values card vs CPU "
          f"{t['rel']}")
    check(t["flip_within"], f"[{tag}] a gp_trigger decision far from its "
          "threshold differs between card and CPU")
    del model, cpu_model
    torch.cuda.empty_cache()
    return res


def phase_soak_quick(tmp: str) -> None:
    """Phase 16: `python -m dvg_tpu_torch.cli.soak --quick` (DCGAN-64 at
    the recipe's width, 2 epochs of 25 steps at B 100, an eval of 8
    futures × n_eval 20 × 2 batches, the trigger run), then K1 and K2
    against plain on its checkpoint's frames and the f32 card-vs-CPU
    checks (`trained_checks`)."""
    out = Path(tmp) / "soak_quick"
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "dvg_tpu_torch.cli.soak",
                        "--quick", "--keep_ckpt", "--out", str(out)],
                       cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"[soak quick] the soak failed (rc "
          f"{p.returncode}):\n{p.stderr[-3000:]}")
    man = json.loads((out / "manifest.json").read_text())
    summ = man["summary"]
    epochs = [r for r in read_records(out / "train") if r["kind"] == "epoch"]
    n_free = 20 - 5
    print(f"[soak quick] {man['device']}: {wall:.1f} s wall (train "
          f"{man['wall_s']['train']} s, eval {man['wall_s']['eval']} s, "
          f"trigger {man['wall_s']['trigger']} s); summary {summ}")
    check(len(epochs) == 2 and all(math.isfinite(r["epoch_mse"])
                                   for r in epochs), f"epochs {epochs}")
    check(summ.get("k1_launches_per_batch") == [n_free] * 2,
          f"K1 launches per eval batch {summ.get('k1_launches_per_batch')}")
    for k in ("batch0_best_of_8_ssim", "batch1_best_of_8_ssim",
              "batch0_mean_ssim", "batch1_mean_ssim", "trigger_count"):
        check(k in summ and math.isfinite(summ[k]), f"summary {k}")
    check(CARD_LINE in man["device"], f"manifest device {man['device']}")
    trained_checks(str(out / "model"), "soak quick")


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
    started = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    try:
        resources = timed("environment and build", phase_environment)
        k1 = timed("k1", phase_k1)
        k2 = timed("k2", phase_k2, resources)
        k3 = timed("k3", phase_k3, resources)
        timed("resample", phase_resample)
        k4 = timed("k4", phase_k4, resources)
        with tempfile.TemporaryDirectory(prefix="dvg_smoke_") as tmp:
            ckpt = timed("ckpt", phase_checkpoint, tmp)
            timed("tiny", phase_tiny)
            timed("gen-tiny", phase_gen_tiny)
            cfg, fns, x, out, k1["launches"], k3["launches"] = timed(
                "main", phase_main, ckpt)
            k2["launches"] = timed("gen-full", phase_gen_full, cfg, fns, x,
                                   out)
            timed("profile", phase_profile, fns, x)
            x_main, out_main = x.cpu(), {k: v.cpu() for k, v in out.items()}
            del fns, x, out
            torch.cuda.empty_cache()
            timed("cli", phase_cli, tmp)
            timed("train tiny", phase_train_tiny)
            timed("train full", phase_train_full)
            timed("train cli", phase_train_cli, tmp)
            timed("backbones tiny", phase_backbones_tiny)
            full = timed("backbones full", phase_backbones_full, tmp)
            train_ms = timed("backbones train", phase_backbones_train)
            timed("backbones cli", phase_backbones_cli, tmp)
            timed("import", phase_import, tmp)
            dist = timed("dist", phase_dist, tmp, ckpt, x_main, out_main)
            k1["dist_launches"], k2["dist_launches"] = dist["k1"], dist["k2"]
            k3["dist_launches"] = dist["k3"]
            serve = timed("serve", phase_serve, tmp, ckpt, x_main)
            k1["serve_launches"], k2["serve_launches"], \
                k3["serve_launches"] = serve["k1"], serve["k2"], serve["k3"]
            timed("soak quick", phase_soak_quick, tmp)
        print(f"[backbones] {CARD_LINE}: " + "; ".join(
            f"{name} protocol {r['fps']:,.0f} frames/s ({r['ms']:.1f} ms, "
            f"K1 {r['launches']} launches, {r['k1_us']:.1f} us each, K3 "
            f"{r['k3']} launches)"
            for name, r in full.items())
            + f"; VGG-128 bf16 train step {train_ms:.2f} ms")
        spilled = spills(resources)
        print(f"[build] {len(resources)} kernel instances, spills: "
              f"{spilled or 'none'}")
        check(not spilled, f"ptxas reports spills: {spilled}")
        print(f"[time] total {time.perf_counter() - started:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    source = "dvg_tpu_torch/csrc/ssim_cyclic.cu"
    kernels = [dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=k["launches"], max_abs_err=k["max_abs_err"],
                    ms=k["ms"], plain_ms=k["plain_ms"],
                    bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                    library_ms=None, dist_launches=k["dist_launches"],
                    serve_launches=k["serve_launches"])
               for name, replaces, k in (
                   ("ssim_cyclic", "dvg_tpu/ops/pallas_ssim.py:187", k1),
                   ("ssim_images", "dvg_tpu/ops/pallas_ssim.py:153", k2))]
    # K3 replaces no Pallas kernel: XLA fused the epilogue into the conv.
    # Its launches: per call of the main path, per rank of the sharded
    # protocol, per call of the diverse_metrics artifact, per call of each
    # backbone's full-width protocol
    kernels.append(dict(name="conv_epilogue", route="cuda",
                        source="dvg_tpu_torch/csrc/conv_epilogue.cu",
                        replaces=None, library_ms=None, backbone_launches={
                            name: r["k3"] for name, r in full.items()},
                        **k3))
    # K4 replaces no Pallas kernel: XLA fused train-mode BatchNorm and its
    # activation; its launches: per step of the train cell
    kernels.append(dict(name="bn_act", route="cuda",
                        source="dvg_tpu_torch/csrc/bn_act.cu", replaces=None,
                        **k4))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
