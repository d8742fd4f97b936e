"""The port's training CLI (`python -m dvg_tpu_torch.cli.train`) on the CPU
at a tiny geometry (g_dim 8, rnn 16, batch 2, n_past 2, n_future 1) on
procedural Moving-MNIST digits: the files and epoch records a run writes;
a checkpoint that `dvg_tpu` resumes from (its TrainState layout) and that
the port's eval CLI scores; --resume continuing the same batch stream, so
that 2 epochs + a resumed third equal 3 epochs in one run, bit for bit;
--trace_dir; the refusal of --mesh 2 in one process; and no hidden
device.

--resume under changed settings: one TrainState resumed by each package's
CLI with --lr and --no_ft changed from the file's. `dvg_tpu` builds its
optimizers from the command line and takes only the file's leaves, so the
resumed epoch's Adam rates, GP schedule and updates per batch are the
command line's; the port's must be too."""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from dvg_tpu.cli import train as j_train_cli
from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.train import checkpoint as jckpt
from dvg_tpu.train.optim import gp_lr_schedule as j_gp_lr_schedule
from dvg_tpu.train.step import init_train_state as j_init_train_state
from dvg_tpu_torch.checkpoint import load_checkpoint, load_train_state
from dvg_tpu_torch.cli import generate as gen_cli
from dvg_tpu_torch.cli import train as train_cli
from dvg_tpu_torch.config import DVGConfig

EPOCH_SIZE = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps this file's small CPU steps from
    oversubscribing the cores (it runs no slower alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_args(out, *extra, niter=2, device="cpu"):
    return ["--dataset", "smmnist", "--data_root", str(out / "no_mnist"),
            "--output_path", str(out), "--log_dir", str(out / "logs"),
            "--niter", str(niter), "--epoch_size", str(EPOCH_SIZE),
            "--batch_size", "2", "--n_past", "2", "--n_future", "1",
            "--n_eval", "4", "--g_dim", "8", "--rnn_size", "16",
            "--ckpt_every", "1", "--data_threads", "1", "--device", device,
            *extra]


def epochs(out):
    with open(out / "logs" / "metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if r["kind"] == "epoch"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A: 2 epochs, then --resume to 3. Run B: 3 epochs at once."""
    a, b = (tmp_path_factory.mktemp(n) for n in ("a", "b"))
    assert train_cli.main(train_args(a)) == 0
    after_two = load_checkpoint(str(a))[2]
    files_two = sorted(p.name for p in a.iterdir())
    assert train_cli.main(train_args(a, "--resume", niter=3)) == 0
    assert train_cli.main(train_args(b, niter=3)) == 0
    return a, b, after_two, files_two


def test_run_writes_checkpoint_samples_and_epoch_records(runs):
    a, _, after_two, files_two = runs
    for name in ("model.ckpt", "sample_0.png", "sample_0.gif",
                 "sample_1.png", "sample_1.gif", "logs"):
        assert name in files_two, (name, files_two)
    assert int(after_two["step"]) == 2 * EPOCH_SIZE
    recs = epochs(a)
    assert [r["step"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert np.isfinite(r["epoch_mse"]) and r["step_s"] > 0
        assert r["frames_seen"] == (r["step"] + 1) * EPOCH_SIZE * 2
    assert (a / "sample_2.gif").stat().st_size > 0
    with open(a / "sample_0.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_resume_continues_the_batch_stream(runs):
    """2 epochs + a resumed third equal 3 epochs in one run: the same
    weights, BN statistics, optimizer state and step, bit for bit, and
    the same epoch metric."""
    a, b, *_ = runs
    _, sa, pa = load_checkpoint(str(a))
    _, sb, pb = load_checkpoint(str(b))
    assert int(pa["step"]) == int(pb["step"]) == 3 * EPOCH_SIZE
    for k in sb:
        assert torch.equal(sa[k], sb[k]), k
    _, ta = load_train_state(str(a), device="cpu")
    _, tb = load_train_state(str(b), device="cpu")
    assert ta.opts.counts == tb.opts.counts == {
        "frame_predictor": 12, "encoder": 6, "decoder": 6, "gp_group": 12}
    for g, opt in ta.opts.adam.items():
        for pa_, pb_ in zip(ta.opts.params(g), tb.opts.params(g)):
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.state[pa_][key],
                                   tb.opts.adam[g].state[pb_][key])
    assert epochs(a)[2]["epoch_mse"] == epochs(b)[2]["epoch_mse"]


def test_checkpoint_resumes_in_dvg_tpu(runs):
    a, *_ = runs
    cfg, _ = jckpt.load_checkpoint(str(a))
    skeleton = jax.eval_shape(lambda k: j_init_train_state(cfg, k)[1],
                              jax.random.PRNGKey(0))
    jcfg, state = jckpt.load_checkpoint(str(a), target_state=skeleton)
    assert jcfg.g_dim == 8 and int(state.step) == 3 * EPOCH_SIZE
    assert int(state.opt_states["gp_group"][1].count) == 6 * EPOCH_SIZE
    assert int(state.opt_states["encoder"][0].count) == 3 * EPOCH_SIZE


def test_eval_cli_scores_the_trained_checkpoint(runs, tmp_path):
    a, *_ = runs
    assert gen_cli.main([
        "--model_dir", str(a), "--log_dir", str(tmp_path), "--dataset",
        "smmnist", "--data_root", "", "--device", "cpu", "--nsample", "3",
        "--num_batches", "1", "--override_n_eval", "4",
        "--override_batch_size", "2", "--gif_rows", "1"]) == 0
    arrs = np.load(tmp_path / "eval_batch0.npz")
    assert arrs["ssim"].shape == (2, 3, 2)
    assert np.isfinite(arrs["ssim"]).all()


def test_trace_dir(tmp_path):
    assert train_cli.main(train_args(tmp_path, "--trace_dir",
                                     str(tmp_path / "trace"),
                                     niter=1)) == 0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    # the warm-up and traced steps advance the state, as in dvg_tpu
    _, _, payload = load_checkpoint(str(tmp_path))
    assert int(payload["step"]) == EPOCH_SIZE + 1 + train_cli.TRACE_STEPS


def test_mesh_refused(tmp_path):
    """--mesh 2 in one process is refused, naming the launch it needs
    (tests/test_torch_dist_cli.py runs it on two)."""
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        train_cli.main(train_args(tmp_path, "--mesh", "2"))


def test_no_hidden_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    args = train_args(tmp_path)
    args = args[:args.index("--device")]
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(args)


# ---------------------------------------------------------------------------
# --resume under the command line's settings
# ---------------------------------------------------------------------------

RESUME_LR = 0.001       # the file's runs at the default 0.002


def noise_bias(name: str) -> bool:
    """A conv bias feeding a train-mode BN: its gradient is rounding, so
    Adam moves it by ±lr in either package (tests/test_torch_train.py)."""
    return name.endswith("conv.bias") and not name.startswith(
        "decoder.final")


@pytest.fixture(scope="module")
def changed_resume(tmp_path_factory):
    """A TrainState the port's CLI wrote after one epoch (ft on, lr
    0.002), resumed for a second epoch with --lr 0.001 --no_ft by the
    port's CLI and by dvg_tpu's, each on its own copy of the file."""
    base = tmp_path_factory.mktemp("f1_base")
    assert train_cli.main(train_args(base, niter=1)) == 0
    outs = {}
    for name in ("port", "jax"):
        out = tmp_path_factory.mktemp(f"f1_{name}")
        shutil.copy(base / "model.ckpt", out / "model.ckpt")
        args = train_args(out, "--resume", "--lr", str(RESUME_LR),
                          "--no_ft", niter=2)
        if name == "jax":     # dvg_tpu's CLI: no --device; one device
            i = args.index("--device")
            args = args[:i] + args[i + 2:] + ["--mesh", "1"]
            assert j_train_cli.main(args) == 0
        else:
            assert train_cli.main(args) == 0
        outs[name] = out
    return base, outs


def test_resume_takes_the_command_lines_optimizer_settings(changed_resume):
    """After the resumed epoch both packages hold the same update counts
    (the GP group's one per batch without the finetune passes), the same
    next GP rate, and parameters that moved alike: per tensor, the port's
    distance from dvg_tpu's is under 5% of how far dvg_tpu's moved in the
    epoch (the file's lr 0.002 and GP schedule at two updates per batch
    put it at 100% and more), the BN-fed conv biases, moved by rounding,
    excepted."""
    base, outs = changed_resume
    cfg = DVGConfig.from_dict(
        load_checkpoint(str(outs["port"]))[0].to_dict()).replace(
        lr=RESUME_LR, ft=False)
    _, port = load_train_state(str(outs["port"]), cfg, device="cpu")
    jcfg, jstate = jckpt.load_checkpoint(str(outs["jax"]))
    assert port.step == int(jstate["step"]) == 2 * EPOCH_SIZE
    want_counts = {"frame_predictor": 6, "encoder": 4, "decoder": 4,
                   "gp_group": 6}
    j_counts = {g: int(jstate["opt_states"][g]["0"]["count"])
                for g in want_counts}
    assert port.opts.counts == j_counts == want_counts
    assert port.opts.updates_per_batch == 1
    for g in ("frame_predictor", "encoder", "decoder"):
        assert port.opts.adam[g].param_groups[0]["lr"] == RESUME_LR
    j_rate = float(j_gp_lr_schedule(JaxConfig(**cfg.to_dict()))(
        j_counts["gp_group"] // 1))
    assert port.opts.schedule(port.opts.counts["gp_group"]) == j_rate

    _, before, _ = load_checkpoint(str(base))
    _, after_jax, payload = load_checkpoint(str(outs["jax"]))
    after_port = port.model.state_dict()
    assert after_jax.keys() == after_port.keys()
    for k, p_jax in after_jax.items():
        if "running" in k or "num_batches" in k or noise_bias(k):
            continue
        moved = (p_jax.double() - before[k].double()).norm()
        apart = (after_port[k].double() - p_jax.double()).norm()
        assert moved > 0, k
        assert apart <= 0.05 * moved, (k, float(apart / moved))


@pytest.mark.parametrize("run", ["soak_smmnist", "soak_smmnist_torch"])
def test_soak_flags_give_dvg_tpus_config(run):
    """The training flags a soak's manifest records (the TPU's run of
    dvg_tpu's CLI and the port's run of its own) build the same config in
    both CLIs, field for field: the two soaks train one recipe."""
    import dataclasses
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "runs", run, "manifest.json")) as f:
        flags = json.load(f)["train_flags"]
    if "--device" not in flags:
        flags = flags + ["--device", "cpu"]
    args = train_cli.build_parser().parse_args(flags)
    ours = DVGConfig(**{k: v for k, v in vars(args).items()
                        if k in {f.name for f in dataclasses.fields(DVGConfig)}})
    jflags = [f for i, f in enumerate(flags)
              if f != "--device" and (i == 0 or flags[i - 1] != "--device")]
    jargs = j_train_cli.build_parser().parse_args(jflags)
    theirs = JaxConfig(**{k: v for k, v in vars(jargs).items()
                          if k in JaxConfig.__dataclass_fields__})
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.batch_size == 100 and ours.dtype == "bfloat16"
