"""The generation / eval CLI of the port (counterpart of
`dvg_tpu/cli/generate.py`, the same flags):

    python -m dvg_tpu_torch.cli.generate --model_dir RUN --log_dir OUT \\
        [--dataset smmnist --data_root DIR] [--device cuda|cpu] ...

  * restores the `dvg_tpu` checkpoint RUN/model.ckpt and its config, then
    applies the eval protocol's override (n_eval 105, n_future 100, batch
    50), then this run's flags;
  * per test batch: the posterior rollout and `nsample` sampled futures
    scored in the loop (K1 unless --no_pallas; Finn's metric with --finn),
    best-of-N by mean SSIM, the (B, S, T') `ssim` and `psnr` arrays saved
    as eval_batch<i>.npz and an "eval" record in metrics.jsonl; then the
    best and 3 random futures of each of the first --gif_rows rows
    re-rolled exactly and written as sample_lstm_<n>.gif beside the ground
    truth and the posterior;
  * --gp_trigger_flag: the adaptive GP-trigger rollout instead, writing
    every third frame of each row as a strip under the working directory's
    recursive_generation/<row>/ and a "trigger" record;
  * a "time" record per batch: wall seconds of each stage, each ended by a
    device synchronize.

--dtype float32 means f32 arithmetic: cuDNN's and cuBLAS's TF32 are off
for the run (and restored after it), so the GIF re-roll, a batch of 40
pairs where the scored rollout ran S·B clips, gives the scored futures to
f32 rounding. In bf16 the two batch sizes can take different cuDNN
kernels, so a re-rolled future is the scored one to bf16 rounding.

Runs on the card unless --device cpu.

Sharded over S·D processes, one per rank (torchrun --nproc_per_node S·D,
or `dvg_tpu`'s DVG_COORDINATOR / DVG_NUM_PROCESSES / DVG_PROCESS_ID env):
--mesh_samples S splits the futures over S ranks and --mesh_data D the
batch rows over D (D > 1 needs S > 1, as in `dvg_tpu`; --full_cov refuses
D > 1). Every rank reads rank 0's checkpoint bytes, scores its block of
futures and rows, and gathers the whole (S, n_free, B) metrics
(`parallel.shard_diverse_metrics`); rank 0 alone runs the posterior, the
re-roll and the GIFs and writes every file. The blocks draw the eps of the
one-process run, so the scores, and the futures a re-roll replays, are the
one-process run's. The backend is nccl on the card (one rank per card) and
gloo on the CPU; --dist_backend gloo shares one card between ranks.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from dvg_tpu_torch.checkpoint import load_model
from dvg_tpu_torch.data import Loader, load_dataset
from dvg_tpu_torch.generate.rollout import best_of_n, make_rollout_fns
from dvg_tpu_torch.parallel import (distributed_init, is_coordinator,
                                    make_mesh, rank_device,
                                    shard_diverse_metrics, world_size)
from dvg_tpu_torch.utils import (MetricLogger, StepTimer, add_border,
                                 save_gif_with_text, save_image,
                                 trace_context)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DVG generation/eval (PyTorch)")
    # the reference's flags; the geometry flags are restored from the
    # checkpoint, as the reference's generator does
    p.add_argument("--batch_size", default=50, type=int)
    p.add_argument("--log_dir", default="logs_gp")
    p.add_argument("--model_dir", default="")
    p.add_argument("--name", default="")
    p.add_argument("--data_root", default="./data/kth")
    p.add_argument("--seed", default=1, type=int)
    p.add_argument("--image_width", type=int, default=64)
    p.add_argument("--channels", default=1, type=int)
    p.add_argument("--gp_trigger_flag", action="store_true", default=False)
    p.add_argument("--dataset", default=None,
                   help="override the checkpoint's dataset")
    p.add_argument("--n_past", type=int, default=5)
    p.add_argument("--n_future", type=int, default=10)
    p.add_argument("--n_eval", type=int, default=60)
    p.add_argument("--rnn_size", type=int, default=256)
    p.add_argument("--predictor_rnn_layers", type=int, default=2)
    p.add_argument("--z_dim", type=int, default=10)
    p.add_argument("--g_dim", type=int, default=90)
    p.add_argument("--model", default="dcgan")
    p.add_argument("--data_threads", type=int, default=5)
    p.add_argument("--last_frame_skip", action="store_true")
    # the JAX package's extras
    p.add_argument("--nsample", type=int, default=100)
    p.add_argument("--num_batches", type=int, default=5)
    p.add_argument("--mesh_samples", type=int, default=0,
                   help="shard the futures over N ranks")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="with --mesh_samples, also shard the batch rows "
                        "over N ranks")
    p.add_argument("--override_n_eval", type=int, default=0)
    p.add_argument("--override_batch_size", type=int, default=0)
    p.add_argument("--gif_rows", type=int, default=10,
                   help="batch rows to render GIFs for")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--use_pallas", action="store_true", default=None,
                   help="score in the loop with the hand-written kernel K1 "
                        "(the default)")
    p.add_argument("--no_pallas", dest="use_pallas", action="store_false",
                   help="score in the loop with stock torch ops")
    p.add_argument("--trace_dir", default="",
                   help="write a torch.profiler Chrome trace of batch 0")
    p.add_argument("--finn", action="store_true",
                   help="Finn-variant SSIM/PSNR")
    p.add_argument("--trigger_sigma", type=float, default=2.01,
                   help="σ multiple in the GP-trigger threshold")
    p.add_argument("--trigger_margin", type=float, default=0.0,
                   help="absolute margin subtracted from the trigger "
                        "threshold (0 = reference-exact)")
    p.add_argument("--full_cov", action="store_true",
                   help="batch-correlated GP sampling at fork steps")
    # the port's own
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend (default nccl on the card, "
                        "gloo on the CPU; gloo shares one card between "
                        "ranks)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh_data > 1 and args.mesh_samples <= 1:
        raise SystemExit(
            "--mesh_data > 1 extends the sample-parallel mesh to 2-D and "
            "requires --mesh_samples > 1; it would otherwise be silently "
            "ignored")
    created = not dist.is_initialized()
    created &= distributed_init(args.device, args.dist_backend)
    try:
        return _main(args)
    finally:
        if created:
            dist.destroy_process_group()


def _main(args) -> int:
    n_s, n_d = args.mesh_samples, max(1, args.mesh_data)
    world = world_size()
    if (n_s or 1) * n_d != world:
        raise SystemExit(
            f"--mesh_samples {n_s} --mesh_data {args.mesh_data} shard over "
            f"{(n_s or 1) * n_d} rank(s) but {world} process(es) run: launch "
            f"{(n_s or 1) * n_d} with torchrun --nproc_per_node, or with the "
            "DVG_COORDINATOR, DVG_NUM_PROCESSES and DVG_PROCESS_ID env "
            "contract")
    dev = rank_device(args.device)
    timer = StepTimer(warmup=0)

    # ---- restore-then-override -------------------------------------------
    timer.start()
    # under a process group every rank reads rank 0's bytes
    saved_cfg, model = load_model(args.model_dir, device=dev)
    load_s = timer.stop(dev)
    cfg = saved_cfg.generation_override()
    cfg = cfg.replace(log_dir=args.log_dir,
                      dataset=args.dataset or cfg.dataset,
                      data_root=args.data_root,
                      gp_trigger_flag=args.gp_trigger_flag,
                      trigger_sigma=args.trigger_sigma,
                      trigger_margin=args.trigger_margin,
                      nsample=args.nsample, dtype=args.dtype,
                      use_pallas=(True if args.use_pallas is None
                                  else args.use_pallas),
                      full_cov_sampling=args.full_cov,
                      eval_metric="finn" if args.finn else "skimage")
    if args.override_n_eval:
        cfg = cfg.replace(n_eval=args.override_n_eval,
                          n_future=args.override_n_eval - cfg.n_past)
    if args.override_batch_size:
        cfg = cfg.replace(batch_size=args.override_batch_size)
    logger = MetricLogger(cfg.log_dir)
    logger.log(0, {"ckpt_load_s": load_s}, kind="setup")

    test_ds = load_dataset(cfg, seq_len=cfg.n_eval, split="test")
    loader = Loader(test_ds, cfg.batch_size, shuffle=False, seed=cfg.seed,
                    num_threads=args.data_threads, device=dev)
    fns = make_rollout_fns(model, cfg)
    metrics_fn = fns.diverse_metrics
    if n_s and dist.is_initialized():
        if cfg.nsample % n_s or cfg.batch_size % n_d:
            raise SystemExit(f"--nsample {cfg.nsample} and batch "
                             f"{cfg.batch_size} must divide over "
                             f"--mesh_samples {n_s} and --mesh_data {n_d}")
        mesh = make_mesh([("sample", n_s), ("data", n_d)])
        local = make_rollout_fns(model, cfg.replace(nsample=cfg.nsample // n_s))
        metrics_fn = shard_diverse_metrics(local, mesh,
                                           full_cov=cfg.full_cov_sampling)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    if cfg.dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        _run_batches(args, cfg, dev, fns, metrics_fn, loader, logger, timer)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        loader.stop()
    return 0


def _run_batches(args, cfg, dev, fns, metrics_fn, loader, logger, timer
                 ) -> None:
    """Each test batch: load it, score it by `metrics_fn` (or run the GP
    trigger), log, save the arrays and write the GIFs. Under a process
    group every rank scores its block and the coordinator alone does the
    rest."""
    lead = is_coordinator()
    for bi in range(args.num_batches):
        times = {}

        def stage(name, fn):
            timer.start()
            out = fn()
            times[name + "_s"] = timer.stop(dev)
            return out

        print(f"batch {bi}: loading...", flush=True)
        x = stage("batch", lambda: loader.next_batch(bi))
        seed = cfg.seed * 1000 + bi
        if cfg.gp_trigger_flag and not lead:
            continue
        with trace_context(args.trace_dir if bi == 0 and lead else None):
            if cfg.gp_trigger_flag:
                print(f"batch {bi}: gp-trigger rollout...", flush=True)
                frames, diag = stage("trigger", lambda: fns.gp_trigger(
                    x, seed=seed, device=dev))
            else:
                if lead:
                    print(f"batch {bi}: posterior rollout...", flush=True)
                    post = stage("posterior", lambda: fns.posterior(
                        x, device=dev))
                print(f"batch {bi}: {cfg.nsample}-sample diverse rollout + "
                      "in-loop SSIM/PSNR...", flush=True)
                met = stage("metrics", lambda: metrics_fn(
                    x, seed=seed, device=dev))
        if cfg.gp_trigger_flag:
            stage("strips", lambda: _save_trigger_strips(
                frames.cpu().numpy(), bi))
            logger.log(bi, {"triggers": float(diag["triggers"].sum())},
                       kind="trigger")
            logger.log(bi, times, kind="time")
            continue

        ssim = met["ssim"].permute(2, 0, 1).cpu().numpy()      # (B, S, T')
        psnr = met["psnr"].permute(2, 0, 1).cpu().numpy()
        best_idx, best_ssim = best_of_n(torch.from_numpy(ssim))
        logger.save_arrays(f"eval_batch{bi}", ssim=ssim, psnr=psnr)
        logger.log(bi, {"ssim_best_mean": float(best_ssim.mean()),
                        "psnr_mean": float(psnr.mean())}, kind="eval")
        if not lead:
            logger.log(bi, times, kind="time")
            continue
        print(f"batch {bi}: re-rolling selected samples for GIFs...",
              flush=True)
        # per GIF row, [best by SSIM, 3 random] samples, re-rolled exactly:
        # the futures diverse_metrics scored
        rows_n = min(x.shape[1], args.gif_rows)
        rng = np.random.RandomState(bi)
        pair_sids, pair_rows = [], []
        for i in range(rows_n):
            pair_sids += [int(best_idx[i])] + [
                int(v) for v in rng.randint(0, ssim.shape[1], 3)]
            pair_rows += [i] * 4
        if cfg.full_cov_sampling:
            # correlated draws span the whole batch: re-roll each unique
            # sample on the full batch, then slice (sample, row)
            uniq = sorted(set(pair_sids))
            out = stage("reroll", lambda: fns.diverse_rollout_with_keys(
                x, uniq, seed=seed, device=dev)).cpu().numpy()
            pos = {g: j for j, g in enumerate(uniq)}
            frames_of = lambda k: out[pos[pair_sids[k]], :, pair_rows[k]]
        else:
            outp = stage("reroll", lambda: fns.diverse_select_pairs(
                x[:, pair_rows], pair_sids, pair_rows, seed=seed,
                device=dev)).cpu().numpy()             # (n_eval, K, H, W, C)
            frames_of = lambda k: outp[:, k]
        stage("gifs", lambda: _save_sample_gifs(
            x.cpu().numpy(), post.cpu().numpy(), frames_of, rows_n, bi,
            cfg))
        logger.log(bi, times, kind="time")


def _save_sample_gifs(x, post, frames_of, rows_n, batch_idx, cfg):
    """Per GIF row i: ground truth, posterior, best-SSIM and 3 random
    futures, bordered green over the context and red after it, captioned;
    `frames_of(k)` is the (n_eval, H, W, C) future of pair k = 4·i +
    column."""
    for i in range(rows_n):
        pair = [frames_of(4 * i + j) for j in range(4)]
        gifs, texts = [], []
        for t in range(cfg.n_eval):
            color = "green" if t < cfg.n_past else "red"
            row = [add_border(x[t, i], "green"),
                   add_border(post[t, i], color),
                   add_border(pair[0][t], color)]
            txt = ["Ground\ntruth", "Approx.\nposterior", "Best SSIM"]
            for k in range(3):
                row.append(add_border(pair[k + 1][t], color))
                txt.append("Random\nsample %d" % (k + 1))
            gifs.append(row)
            texts.append(txt)
        fname = os.path.join(cfg.log_dir,
                             f"sample_lstm_{batch_idx * x.shape[1] + i}.gif")
        save_gif_with_text(fname, gifs, texts)


def _save_trigger_strips(frames, batch_idx):
    """Every third frame of each batch row as one strip, under the working
    directory's recursive_generation/<row>/."""
    for i in range(frames.shape[1]):
        strip = [frames[t, i] for t in range(0, frames.shape[0], 3)]
        save_image(os.path.join(
            "recursive_generation", str(i),
            f"heuristic_gp_trigger_1_0_b{batch_idx}.png"), [strip])


if __name__ == "__main__":
    sys.exit(main())
