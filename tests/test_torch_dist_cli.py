"""Both CLIs of the port on two gloo ranks on the CPU (the DVG_* env
contract), at tests/test_torch_train_cli.py's tiny geometry with a global
batch of 4 (2 per rank), in one spawn:

  * `python -m dvg_tpu_torch.cli.train --mesh 2`: 2 epochs, then --resume
    to a third. Each rank is given its own --output_path, as on hosts with
    local disks: rank 1's stays empty (only the coordinator writes), and
    its resume takes rank 0's state by broadcast, not its missing file;
  * `python -m dvg_tpu_torch.cli.generate --mesh_samples 2` on rank 0's
    checkpoint (rank 1's --model_dir is empty: it reads rank 0's bytes),
    which the one-process eval scores too;

against the same commands in one process: the epoch records (rtol 1e-3),
the same step and update counts, and the final checkpoint near the
one-process run's; the eval's npz equal (SSIM and MSE 1e-6, PSNR relative
1e-6) and the same files.

"Near", in f32: this tiny f32 step amplifies any change of reduction
order (BN over 4 frames per call, Adam's first updates ~ sign(g)), so
after 6 steps a one-process run whose batch rows are merely permuted
also sits a few % of the resumed epoch's movement from the unpermuted
run (every tensor together), and tens of % for single small tensors such
as gp.mean_const. The bands are 25% together and 100% per tensor, the
running statistics and the BN-fed conv biases, moved by rounding,
excepted. The exact equality of the data-parallel step is held in f64,
at 1e-10, by tests/test_torch_parallel.py.

The spawned ranks import this module (spawn start method), which
therefore imports no JAX."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from dvg_tpu_torch.checkpoint import load_checkpoint, load_train_state
from dvg_tpu_torch.cli import generate as gen_cli
from dvg_tpu_torch.cli import train as train_cli
from dvg_tpu_torch.parallel import is_coordinator
from dvg_tpu_torch.parallel.dryrun import free_port, noise_bias, run_ranks

EPOCH_SIZE = 2
EVAL_TOL = 1e-6


def train_args(out: Path, *extra, niter=2):
    return ["--dataset", "smmnist", "--data_root", str(out / "no_mnist"),
            "--output_path", str(out / "run"),
            "--log_dir", str(out / "run" / "logs"),
            "--niter", str(niter), "--epoch_size", str(EPOCH_SIZE),
            "--batch_size", "4", "--n_past", "2", "--n_future", "1",
            "--n_eval", "4", "--g_dim", "8", "--rnn_size", "16",
            "--ckpt_every", "1", "--data_threads", "1", "--device", "cpu",
            *extra]


def eval_args(out: Path, *extra, model_dir=None):
    return ["--model_dir", str(model_dir or out / "run"),
            "--log_dir", str(out / "eval"),
            "--dataset", "smmnist", "--data_root", str(out / "no_mnist"),
            "--device", "cpu", "--nsample", "4", "--num_batches", "1",
            "--override_n_eval", "4", "--override_batch_size", "2",
            "--gif_rows", "2", *extra]


def run_all(out: Path, *mesh, model_dir=None) -> list:
    """Train 2 epochs, resume to 3, then evaluate the checkpoint in
    `model_dir` (default: the one trained); the coordinator keeps the
    2-epoch checkpoint as out/two.ckpt."""
    train_mesh = ["--mesh", "2"] if mesh else []
    rcs = [train_cli.main(train_args(out, *train_mesh))]
    if is_coordinator():
        shutil.copy(out / "run" / "model.ckpt", out / "two.ckpt")
    return rcs + [train_cli.main(train_args(out, *train_mesh, "--resume",
                                            niter=3)),
                  gen_cli.main(eval_args(out, *mesh, model_dir=model_dir))]


def _cli_rank(rank: int, n: int, port: int, root: str) -> None:
    os.environ.update(DVG_COORDINATOR=f"localhost:{port}",
                      DVG_NUM_PROCESSES=str(n), DVG_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from dvg_tpu_torch.parallel import distributed_init
    if not distributed_init(device="cpu"):
        raise RuntimeError("the DVG_* env did not start a group")
    rcs = run_all(Path(root) / f"rank{rank}", "--mesh_samples", "2")
    (Path(root) / f"rc{rank}.json").write_text(json.dumps(rcs))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_ranks(_cli_rank, 2, (free_port(), str(root)), timeout_s=600)
        # the one-process eval scores the 2-rank run's checkpoint
        rcs_one = run_all(root / "one", model_dir=root / "rank0" / "run")
    finally:
        torch.set_num_threads(n)
    rcs = [json.loads((root / f"rc{r}.json").read_text()) for r in range(2)]
    return root, rcs, rcs_one


def records(logs: Path, kind: str) -> list:
    with open(logs / "metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_every_command_succeeds(runs):
    _, rcs, rcs_one = runs
    assert rcs == [[0, 0, 0], [0, 0, 0]] and rcs_one == [0, 0, 0]


def test_only_the_coordinator_writes(runs):
    """Rank 0 writes the checkpoint, plots, metrics, npz and GIFs; rank 1,
    whose own directories were named on its command lines, writes
    nothing at all."""
    root, *_ = runs
    run, ev = root / "rank0" / "run", root / "rank0" / "eval"
    for name in ("model.ckpt", "sample_0.png", "sample_2.gif",
                 "logs/metrics.jsonl", "../two.ckpt"):
        assert (run / name).stat().st_size > 0, name
    assert sorted(p.name for p in ev.iterdir()) == sorted(
        p.name for p in (root / "one" / "eval").iterdir())
    assert not (root / "rank1").exists()


def test_dp_run_matches_one_process(runs):
    """2 ranks × 2 rows against 1 process × 4 rows: the epoch records and
    the resumed checkpoint. Rank 1 held no checkpoint, so without the
    resume broadcast it would have stepped its seeded weights and its
    gradients would have pulled rank 0's off the one-process run."""
    root, *_ = runs
    dp, one = root / "rank0" / "run", root / "one" / "run"
    got, want = records(dp / "logs", "epoch"), records(one / "logs", "epoch")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["epoch_mse"], w["epoch_mse"], rtol=1e-3)
    _, sd_dp, p_dp = load_checkpoint(str(dp))
    _, sd_one, p_one = load_checkpoint(str(one))
    assert int(p_dp["step"]) == int(p_one["step"]) == 3 * EPOCH_SIZE
    _, st_dp = load_train_state(str(dp), device="cpu")
    _, st_one = load_train_state(str(one), device="cpu")
    assert st_dp.opts.counts == st_one.opts.counts
    # how far the resumed epoch moved the one-process run
    _, before, _ = load_checkpoint(str(root / "one" / "two.ckpt"))
    keys = [k for k in sd_one if not ("running" in k or "num_batches" in k
                                      or noise_bias(k))]

    def flat(sd, k):
        return sd[k].double().reshape(-1)
    for k in keys:
        moved = (flat(sd_one, k) - flat(before, k)).norm()
        apart = (flat(sd_dp, k) - flat(sd_one, k)).norm()
        assert moved > 0 and apart <= moved, (k, float(apart / moved))
    moved = torch.cat([flat(sd_one, k) - flat(before, k) for k in keys])
    apart = torch.cat([flat(sd_dp, k) - flat(sd_one, k) for k in keys])
    assert apart.norm() <= 0.25 * moved.norm(), float(
        apart.norm() / moved.norm())


def test_eval_cli_mesh_samples_matches_one_process(runs):
    root, *_ = runs
    got = np.load(root / "rank0" / "eval" / "eval_batch0.npz")
    want = np.load(root / "one" / "eval" / "eval_batch0.npz")
    assert got["ssim"].shape == want["ssim"].shape == (2, 4, 2)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0,
                               atol=EVAL_TOL)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=EVAL_TOL)
    ev = records(root / "rank0" / "eval", "eval")
    assert len(ev) == 1 and np.isfinite(ev[0]["ssim_best_mean"])
