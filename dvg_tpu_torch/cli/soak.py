"""The training soak of the port (counterpart of `scripts/soak.py`): the
reference Moving-MNIST recipe through the port's own CLIs, kept as a run
directory.

    python -m dvg_tpu_torch.cli.soak [--out runs/soak_smmnist_torch]
        [--niter 50] [--epoch_size 300] [--quick] [--device cuda|cpu]

  1. `python -m dvg_tpu_torch.cli.train`: DCGAN-64, 1 channel, g_dim 90,
     rnn 256×2, n_past 5, n_future 10, bf16, seed 1, 50 epochs × 300
     steps at batch 100, a checkpoint every 10 epochs;
  2. `python -m dvg_tpu_torch.cli.generate` on the last checkpoint: the
     reference eval protocol, 100 futures, n_eval 105, batch 50, 2
     batches, bf16, K1 scoring in the loop;
  3. the same with --gp_trigger_flag on one batch;
  4. manifest.json: the flags, git revision, the card's name and power
     limit (as `nvidia-smi --query-gpu=name,power.limit
     --format=csv,noheader` prints them), wall seconds and `summarize`'s
     summary; then the renders go but the training's epoch plots
     (model/sample_<epoch>.png, as scripts/soak.py keeps them), and a
     checkpoint over 64 MB unless --keep_ckpt.

Each CLI runs as a subprocess from the run directory (the trigger run's
strips land there), its console in <out>/{train,eval,trigger}_stdout.log.
The data is the seed-pinned procedural Moving-MNIST unless --data_root
holds MNIST's idx files. --quick: 2 × 25 steps and an eval of 8 futures ×
n_eval 20 × 2 batches, a check of this script, not the soak; --tiny: the
whole run at a tiny geometry, for the CPU. Runs on the card unless --device
cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from dvg_tpu_torch.config import resolve_device
from dvg_tpu_torch.data.moving_mnist import _mnist_file_exists

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the recipe's geometry (scripts/soak.py:65-83), and the two cuts of it
RECIPE = dict(g_dim=90, rnn_size=256, n_past=5, n_future=10, nsample=100,
              eval_n_eval=105, eval_batch=50, eval_batches=2)
QUICK = dict(niter=2, epoch_size=25, nsample=8, eval_n_eval=20)
TINY = dict(niter=2, epoch_size=1, train_batch=2, g_dim=8, rnn_size=16,
            n_past=2, n_future=1, nsample=2, eval_n_eval=12, eval_batch=2,
            eval_batches=1)
CKPT_KEEP_BYTES = 64 << 20


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DVG training soak (PyTorch)")
    # scripts/soak.py's flags
    p.add_argument("--out", default="runs/soak_smmnist_torch")
    p.add_argument("--niter", type=int, default=50)
    p.add_argument("--epoch_size", type=int, default=300)
    p.add_argument("--train_batch", type=int, default=100)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--data_root", default="",
                   help="MNIST idx location; empty: the seed-pinned "
                        "procedural glyph set")
    p.add_argument("--quick", action="store_true")
    # the port's own
    p.add_argument("--tiny", action="store_true",
                   help="2 × 1 steps at B 2, g_dim 8, rnn 16, an eval of 2 "
                        "futures × n_eval 12 × 1 batch of 2: the whole run on "
                        "the CPU in seconds")
    p.add_argument("--device", default="cuda")
    p.add_argument("--keep_ckpt", action="store_true",
                   help="keep model/model.ckpt whatever its size")
    return p


def run(cmd: List[str], cwd: str, log_path: str) -> float:
    """cmd from cwd with the repo importable, its console to log_path →
    wall seconds; a failure raises with the end of the log."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [v for v in [os.environ.get("PYTHONPATH")] if v]))
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        p = subprocess.run(cmd, cwd=cwd, env=env, stdout=f,
                           stderr=subprocess.STDOUT)
    if p.returncode != 0:
        with open(log_path) as f:
            sys.stderr.write(f.read()[-4000:])
        raise SystemExit(f"{' '.join(cmd[1:4])} failed rc={p.returncode} "
                         f"(log {log_path})")
    return time.perf_counter() - t0


def _records(path: str) -> List[Dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def summarize(out: str, nsample: int, batches: int) -> Dict:
    """The run's headline numbers from its files.

    eval/eval_batch<i>.npz holds `ssim` as (B, S, T') (both packages' eval
    CLIs write it so): best-of-S is the mean over T', the max over S, the
    mean over B, which is what the CLI's `best_of_n` selects and logs as
    ssim_best_mean. Mean SSIM is over every entry. From train/metrics.jsonl
    the first and last epoch's epoch_mse and the last epoch's step_s; from
    eval/metrics.jsonl the trigger run's count and, where the CLI logged
    them, K1's launches per eval batch."""
    summary: Dict = {}
    for bi in range(batches):
        npz = os.path.join(out, "eval", f"eval_batch{bi}.npz")
        if os.path.exists(npz):
            with np.load(npz) as z:
                ssim = z["ssim"]                              # (B, S, T')
            summary[f"batch{bi}_best_of_{nsample}_ssim"] = float(
                ssim.mean(axis=2).max(axis=1).mean())
            summary[f"batch{bi}_mean_ssim"] = float(ssim.mean())
    ep = [r for r in _records(os.path.join(out, "train", "metrics.jsonl"))
          if r.get("kind") == "epoch"]
    if ep:
        summary["first_epoch_mse"] = ep[0].get("epoch_mse")
        summary["last_epoch_mse"] = ep[-1].get("epoch_mse")
        summary["sustained_step_s"] = ep[-1].get("step_s")
    recs = _records(os.path.join(out, "eval", "metrics.jsonl"))
    trig = [r for r in recs if r.get("kind") == "trigger"]
    if trig:
        summary["trigger_count"] = sum(r["triggers"] for r in trig)
    launches = [r["k1_launches"] for r in recs
                if r.get("kind") == "eval" and "k1_launches" in r]
    if launches:
        summary["k1_launches_per_batch"] = launches
    return summary


def device_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    CPU's name."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"cpu ({platform.machine()}, {os.cpu_count()} cores)"
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        lines = q.stdout.strip().splitlines()
        return lines[dev.index or 0] if lines else q.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        import torch
        return f"{torch.cuda.get_device_name(dev)} (nvidia-smi: {e})"


def _git_rev() -> Optional[str]:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                              capture_output=True, text=True
                              ).stdout.strip() or None
    except OSError:
        return None


def _drop_renders(out: str, keep_ckpt: bool) -> None:
    """The GIF and PNG renders and the trigger strips go, but the
    training's epoch plots (model/*.png); so does a checkpoint too big for
    git, unless asked to keep it."""
    for sub in ("eval", "train", "model"):
        d = os.path.join(out, sub)
        for name in os.listdir(d) if os.path.isdir(d) else ():
            if name.endswith(".gif") or (name.endswith(".png")
                                         and sub != "model"):
                os.remove(os.path.join(d, name))
    shutil.rmtree(os.path.join(out, "recursive_generation"),
                  ignore_errors=True)
    ckpt = os.path.join(out, "model", "model.ckpt")
    if (not keep_ckpt and os.path.exists(ckpt)
            and os.path.getsize(ckpt) > CKPT_KEEP_BYTES):
        os.remove(ckpt)


def main(argv=None, launcher: Optional[List[str]] = None) -> int:
    """`launcher`: the command that runs a CLI module given its name and
    flags (default `python -m`)."""
    args = build_parser().parse_args(argv)
    device = device_line(args.device)        # no card: raises before work
    for k, v in RECIPE.items():
        setattr(args, k, v)
    for preset, on in ((QUICK, args.quick), (TINY, args.tiny)):
        for k, v in preset.items() if on else ():
            setattr(args, k, v)
    out = os.path.abspath(args.out)
    model_dir = os.path.join(out, "model")
    os.makedirs(model_dir, exist_ok=True)

    train_flags = [
        "--dataset", "smmnist", "--channels", "1", "--image_width", "64",
        "--batch_size", str(args.train_batch), "--n_past", str(args.n_past),
        "--n_future", str(args.n_future),
        "--n_eval", str(args.n_past + args.n_future),
        "--g_dim", str(args.g_dim), "--rnn_size", str(args.rnn_size),
        "--model", "dcgan", "--dtype", "bfloat16",
        "--seed", str(args.seed), "--niter", str(args.niter),
        "--epoch_size", str(args.epoch_size), "--ckpt_every", "10",
        "--data_root", args.data_root, "--device", args.device,
        "--output_path", model_dir, "--log_dir", os.path.join(out, "train"),
    ]
    gen_flags = [
        "--model_dir", model_dir, "--dataset", "smmnist",
        "--data_root", args.data_root, "--seed", str(args.seed),
        "--nsample", str(args.nsample),
        "--override_n_eval", str(args.eval_n_eval),
        "--override_batch_size", str(args.eval_batch),
        "--num_batches", str(args.eval_batches),
        "--dtype", "bfloat16", "--device", args.device,
        "--log_dir", os.path.join(out, "eval"),
    ]
    cli = list(launcher or [sys.executable, "-m"])
    t_train = run([*cli, "dvg_tpu_torch.cli.train", *train_flags], out,
                  os.path.join(out, "train_stdout.log"))
    t_eval = run([*cli, "dvg_tpu_torch.cli.generate", *gen_flags], out,
                 os.path.join(out, "eval_stdout.log"))
    t_trig = run([*cli, "dvg_tpu_torch.cli.generate", *gen_flags,
                  "--gp_trigger_flag", "--num_batches", "1"], out,
                 os.path.join(out, "trigger_stdout.log"))

    mnist = bool(args.data_root) and _mnist_file_exists(args.data_root,
                                                        train=True)
    manifest = {
        "protocol": ("reference train.py:340-392 (smmnist) + "
                     "generate_frames.py:138-178 eval + GPtrigger_gen, "
                     "through dvg_tpu_torch's CLIs"),
        "train_flags": train_flags, "eval_flags": gen_flags,
        "dataset_note": (f"real MNIST at {args.data_root}" if mnist else
                         "procedural glyph Moving-MNIST (no MNIST idx "
                         "files at data_root), seed-pinned, reproducible "
                         "from the repo alone"),
        "git_rev": _git_rev(), "device": device,
        "wall_s": {"train": round(t_train, 1), "eval": round(t_eval, 1),
                   "trigger": round(t_trig, 1)},
        "summary": summarize(out, args.nsample, args.eval_batches),
    }
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    _drop_renders(out, args.keep_ckpt)
    print(json.dumps(manifest["summary"] | {"out": args.out,
                                            "wall_s": manifest["wall_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
