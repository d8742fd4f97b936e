"""The training CLI of the port (counterpart of `dvg_tpu/cli/train.py`, the
same flags and defaults, plus --device):

    python -m dvg_tpu_torch.cli.train --dataset smmnist --data_root DIR \\
        --output_path RUN --log_dir RUN/logs [--device cuda|cpu] ...

Data parallel over N processes, one per rank:

    torchrun --nproc_per_node N -m dvg_tpu_torch.cli.train --mesh N ...

or N processes each with DVG_COORDINATOR=host:port, DVG_NUM_PROCESSES=N
and its DVG_PROCESS_ID (`dvg_tpu`'s env contract). --mesh must equal the
number of processes (0: whatever that number is). Each rank steps on its
B/N rows of the global batch --batch_size; BN's statistics, the GP's
num_data and the averaged gradients are the global batch's, so every rank
holds the weights of one process training on the whole batch
(`train/step.py`). The backend is nccl on the card (one rank per card)
and gloo on the CPU; --dist_backend gloo shares one card between ranks.
Only rank 0 writes: metrics.jsonl, the plots and the checkpoint; with
--resume rank 0 reads the checkpoint and broadcasts the state, so no rank
keeps its seeded weights.

  * seeded weights (--seed), or with --resume the TrainState in
    <output_path>/model.ckpt, written by either package: its weights, BN
    statistics, Adam moments, update counts and step, under the command
    line's config; the run continues the Loader's batch stream at the
    checkpoint's step;
  * --model dcgan|vgg and --image_width 64|128 pick one of the four
    backbones (`models/registry.py`);
  * per epoch, --epoch_size train steps (the joint and, unless --no_ft, the
    two finetune passes each); the reference's epoch metric, Σ over the
    epoch of mse_latent/T + (ft_mse_latent + ft_gp_nll)/T, accumulates on
    the device and is read once per epoch, then logged as an "epoch" record
    with frames_seen and step_s;
  * every --ckpt_every epochs, the training-time plot (5 samples forked
    once at step 10, best-of-5 by MSE beside 4 random draws:
    sample_<epoch>.png and .gif in output_path) and a rotating model.ckpt
    that `dvg_tpu` resumes from and both eval CLIs score;
  * --trace_dir: a torch.profiler Chrome trace of 3 steps after a warm-up
    step (which advance the state, as in `dvg_tpu`);
  * --dtype bfloat16: `dvg_tpu`'s mixed precision; --remat: the encoder
    and decoder sweeps recompute their activations in the backward.

--dtype float32 means f32 arithmetic: cuDNN's and cuBLAS's TF32 are off
for the run. The shapes of a run are fixed, so cuDNN's autotuner
(cudnn.benchmark) is on; both settings are restored after the run. Runs on
the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from dvg_tpu_torch.checkpoint import CKPT_NAME, load_train_state, \
    save_train_state
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.data import Loader, load_dataset
from dvg_tpu_torch.generate.rollout import make_rollout_fns
from dvg_tpu_torch.parallel import (broadcast_state, distributed_init,
                                    is_coordinator, rank_device, world_size)
from dvg_tpu_torch.parallel.collectives import broadcast_object
from dvg_tpu_torch.train import init_train_state, make_train_step
from dvg_tpu_torch.utils import (MetricLogger, StepTimer, save_gif,
                                 save_image, trace_context)

TRACE_STEPS = 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DVG training (PyTorch)")
    # the reference's flags, same names and defaults
    p.add_argument("--lr", default=0.002, type=float)
    p.add_argument("--beta1", default=0.9, type=float)
    p.add_argument("--batch_size", default=50, type=int)
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--model_dir", default="")
    p.add_argument("--name", default="")
    p.add_argument("--output_path", default=".")
    p.add_argument("--data_root", default="path/to/data/")
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--niter", type=int, default=601)
    p.add_argument("--seed", default=1, type=int)
    p.add_argument("--epoch_size", type=int, default=300)
    p.add_argument("--image_width", type=int, default=64)
    p.add_argument("--channels", default=1, type=int)
    p.add_argument("--dataset", default="kth")
    p.add_argument("--n_past", type=int, default=5)
    p.add_argument("--ft", dest="ft", action="store_true", default=True)
    p.add_argument("--no_ft", dest="ft", action="store_false")
    p.add_argument("--n_future", type=int, default=10)
    p.add_argument("--n_eval", type=int, default=15)
    p.add_argument("--rnn_size", type=int, default=256)
    p.add_argument("--predictor_rnn_layers", type=int, default=2)
    p.add_argument("--z_dim", type=int, default=10)
    p.add_argument("--g_dim", type=int, default=90)
    p.add_argument("--model", default="dcgan", choices=["dcgan", "vgg"])
    p.add_argument("--data_threads", type=int, default=5)
    p.add_argument("--last_frame_skip", action="store_true")
    p.add_argument("--num_digits", type=int, default=2)
    # the JAX package's extras
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel ranks; must equal the number of "
                        "processes launched (0: that number)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ckpt_every", type=int, default=4)
    p.add_argument("--trace_dir", default="")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="conv/LSTM compute dtype (bf16 mixed precision: "
                        "f32 master params, losses, GP, BN statistics)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the conv sweeps' activations in the "
                        "backward")
    # the port's own
    p.add_argument("--device", default="cuda",
                   help="torch device to train on")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend (default nccl on the card, "
                        "gloo on the CPU; gloo shares one card between "
                        "ranks)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    created = not dist.is_initialized()
    created &= distributed_init(args.device, args.dist_backend)
    try:
        return _main(args)
    finally:
        if created:
            dist.destroy_process_group()


def _main(args) -> int:
    world = world_size()
    if (args.mesh or world) != world:
        raise SystemExit(
            f"--mesh {args.mesh} asks for {args.mesh} data-parallel ranks "
            f"but {world} process(es) run: launch with torchrun "
            f"--nproc_per_node {args.mesh} -m dvg_tpu_torch.cli.train --mesh "
            f"{args.mesh} ..., or with the DVG_COORDINATOR, "
            "DVG_NUM_PROCESSES and DVG_PROCESS_ID env contract")
    group = dist.group.WORLD if world > 1 else None
    rank = dist.get_rank() if group is not None else 0
    dev = rank_device(args.device)
    fields = {f.name for f in dataclasses.fields(DVGConfig)}
    cfg = DVGConfig(**{k: v for k, v in vars(args).items() if k in fields})
    logger = MetricLogger(cfg.log_dir)

    # ---- state: seeded, or resumed from either package's TrainState; rank
    # 0's on every rank (a peer's disk may hold no or a stale checkpoint) -
    ckpt_path = os.path.join(cfg.output_path, CKPT_NAME)
    resume = args.resume and is_coordinator() and os.path.exists(ckpt_path)
    if group is not None:
        resume = broadcast_object(resume)
    if resume and is_coordinator():
        # the file's leaves under this run's config (its lr, beta1, GP
        # schedule and updates per batch), as dvg_tpu's CLI resumes
        _, state = load_train_state(ckpt_path, cfg, device=dev, synced=False)
    else:
        state = init_train_state(cfg, device=dev)
    state = broadcast_state(state)
    if resume:
        print(f"resumed from {ckpt_path}" if is_coordinator()
              else f"rank {rank} resumed from rank 0's state")
    start_epoch = state.step // cfg.epoch_size
    if args.resume and start_epoch:
        print(f"resuming at epoch {start_epoch}")

    # ---- data ---------------------------------------------------------------
    train_ds = load_dataset(cfg, seq_len=cfg.seq_len_train, split="train")
    test_ds = load_dataset(cfg, seq_len=max(cfg.n_eval, cfg.seq_len_train),
                           split="test")
    train_loader = Loader(train_ds, cfg.batch_size, seed=cfg.seed,
                          num_threads=cfg.data_threads, device=dev,
                          rank=rank, world=world)
    test_loader = Loader(test_ds, cfg.batch_size, seed=cfg.seed + 1,
                         shuffle=False, num_threads=cfg.data_threads,
                         device=dev)
    step_fn = make_train_step(cfg, group)
    plot_fns = make_rollout_fns(state.model, cfg)
    backends = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    if cfg.dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    try:
        _train(args, cfg, dev, state, start_epoch, step_fn, plot_fns,
               train_loader, test_loader, logger, ckpt_path)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = backends
        train_loader.stop()
        test_loader.stop()
    return 0


def _train(args, cfg, dev, state, start_epoch, step_fn, plot_fns,
           train_loader, test_loader, logger, ckpt_path) -> None:
    """The epoch loop (reference train.py:340-392)."""
    # the (seed, step) batch stream continues at the checkpoint's step
    batches = train_loader.iter_from(state.step)
    if args.trace_dir:
        step_fn(state, next(batches))
        with trace_context(args.trace_dir):
            for _ in range(TRACE_STEPS):
                step_fn(state, next(batches))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        print(f"profiler trace written to {args.trace_dir}")
    timer = StepTimer(warmup=0)
    seq_len = cfg.seq_len_train
    for epoch in range(start_epoch, cfg.niter):
        epoch_mse = torch.zeros((), device=dev)
        timer.start()
        for _ in range(cfg.epoch_size):
            _, metrics = step_fn(state, next(batches))
            # the reference's epoch metric: mse_ctrl + temp_loss
            epoch_mse += metrics["mse_latent_per_frame"]
            if cfg.ft:
                epoch_mse += (metrics["ft_mse_latent"]
                              + metrics["ft_gp_nll"]) / seq_len
        epoch_mse = float(epoch_mse) / cfg.epoch_size    # one sync per epoch
        epoch_s = timer.stop(dev)
        logger.log(epoch, {"epoch_mse": epoch_mse,
                           "frames_seen": (epoch + 1) * cfg.epoch_size
                           * cfg.batch_size,
                           "step_s": epoch_s / cfg.epoch_size}, kind="epoch")
        if not is_coordinator():
            continue
        print("[%02d] mse loss: %.5f (%d)" % (
            epoch, epoch_mse, epoch * cfg.epoch_size * cfg.batch_size))
        if epoch % args.ckpt_every == 0:
            _plot(cfg, dev, plot_fns, test_loader, epoch)
            save_train_state(ckpt_path, cfg, state)
        if epoch % 10 == 0:
            print("log dir: %s" % cfg.log_dir)


def _plot(cfg, dev, plot_fns, test_loader, epoch) -> None:
    """The training-time qualitative plot (reference train.py:256-335): 5
    samples forked once at frame 10; per row the ground truth, the best of
    the 5 by MSE and 4 random draws."""
    x = test_loader.next_batch(epoch)
    gen = plot_fns.plot_samples(x, seed=epoch, device=dev).cpu().numpy()
    gt = x.cpu().numpy()[:cfg.n_eval]
    nrow = min(cfg.batch_size, 10)
    to_plot, gifs = [], [[] for _ in range(cfg.n_eval)]
    # one RandomState per plot: a fresh draw per row, as the reference's
    rs = np.random.RandomState(epoch)
    for b in range(nrow):
        to_plot.append([gt[t, b] for t in range(cfg.n_eval)])
        mse_s = ((gen[:, :cfg.n_eval, b] - gt[None, :, b]) ** 2
                 ).sum(axis=(1, 2, 3, 4))
        order = [int(np.argmin(mse_s))] + list(rs.randint(0, gen.shape[0], 4))
        for s in order:
            to_plot.append([gen[s, t, b] for t in range(cfg.n_eval)])
        for t in range(cfg.n_eval):
            gifs[t].append([gt[t, b]] + [gen[s, t, b] for s in order])
    save_image(os.path.join(cfg.output_path, f"sample_{epoch}.png"), to_plot)
    save_gif(os.path.join(cfg.output_path, f"sample_{epoch}.gif"), gifs)


if __name__ == "__main__":
    sys.exit(main())
