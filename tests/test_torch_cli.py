"""The port's generation CLI (`python -m dvg_tpu_torch.cli.generate`) on the
CPU from a checkpoint that `dvg_tpu` wrote from `init_train_state`, at a
tiny geometry (g_dim 8, rnn 16, n_past 2; override n_eval 4, batch 2,
nsample 4): the artifact set `tests/test_e2e_cli.py` checks for the
default, --finn, --no_pallas, --full_cov and --gp_trigger_flag runs; the
npz equal to the port's own `diverse_metrics(seed=1000·seed + batch)`; the
GIF's ground-truth and posterior columns, before encoding, against
`dvg_tpu`'s `add_border` of `dvg_tpu`'s posterior on the same batch (atol
1e-4); a --trace_dir trace; the refusal of mesh flags one process cannot
serve; no hidden device;
and a whole run with PIL and imageio unimportable."""

import glob
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.data import Loader as JaxLoader
from dvg_tpu.data import load_dataset as j_load_dataset
from dvg_tpu.generate.rollout import make_rollout_fns as j_make_rollout_fns
from dvg_tpu.models.dvg import DVGModel as JaxModel
from dvg_tpu.train import checkpoint as jckpt
from dvg_tpu.train.step import init_train_state
from dvg_tpu.utils import add_border as j_add_border
from dvg_tpu_torch.checkpoint import load_model
from dvg_tpu_torch.cli import generate as gen_cli
from dvg_tpu_torch.data import Loader, load_dataset
from dvg_tpu_torch.generate.rollout import make_rollout_fns

ROOT = Path(__file__).resolve().parent.parent
GEOM = dict(dataset="smmnist", channels=1, image_width=64, batch_size=4,
            n_past=2, n_future=2, n_eval=4, g_dim=8, rnn_size=16, seed=1,
            num_inducing_points=4)
N_EVAL, B, S = 4, 2, 4


def cli_args(model_dir, log_dir, *extra, n_eval=N_EVAL):
    return ["--model_dir", str(model_dir), "--log_dir", str(log_dir),
            "--dataset", "smmnist", "--data_root", "", "--device", "cpu",
            "--nsample", str(S), "--num_batches", "1",
            "--override_n_eval", str(n_eval), "--override_batch_size",
            str(B), "--gif_rows", "2", *extra]


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A dvg_tpu checkpoint straight from init_train_state, no training.
    Four inducing points: at the init's clustered U[0, 1] inducing points
    a larger K_ZZ is too ill-conditioned for an f32 Cholesky."""
    root = tmp_path_factory.mktemp("cli")
    jcfg = JaxConfig(**GEOM)
    _, state, _ = init_train_state(jcfg, jax.random.PRNGKey(0))
    jckpt.save_checkpoint(str(root / "run"), jcfg, state)
    return root, jcfg, state


@pytest.fixture(scope="module")
def default_run(ckpt):
    """The default path, with the GIF frames held before encoding."""
    root, *_ = ckpt
    held = []
    real = gen_cli.save_gif_with_text

    def hold(path, gifs, texts, **kw):
        held.append((path, gifs))
        real(path, gifs, texts, **kw)

    gen_cli.save_gif_with_text = hold
    try:
        assert gen_cli.main(cli_args(root / "run", root / "default")) == 0
    finally:
        gen_cli.save_gif_with_text = real
    return root / "default", held


def assert_eval_artifacts(logs, gifs=2):
    arrs = np.load(logs / "eval_batch0.npz")
    # (B, S, T') with T' = n_eval - n_past free-run frames
    assert arrs["ssim"].shape == arrs["psnr"].shape == (B, S, N_EVAL - 2)
    assert np.isfinite(arrs["ssim"]).all() and np.isfinite(arrs["psnr"]).all()
    recs = read_jsonl(logs / "metrics.jsonl")
    ev = [r for r in recs if r["kind"] == "eval"]
    assert len(ev) == 1 and np.isfinite(ev[0]["ssim_best_mean"])
    assert np.isfinite(ev[0]["psnr_mean"])
    times = [r for r in recs if r["kind"] == "time"]
    assert len(times) == 1 and {"batch_s", "posterior_s", "metrics_s",
                                "reroll_s", "gifs_s"} <= set(times[0])
    assert len(glob.glob(str(logs / "sample_lstm_*.gif"))) == gifs
    return arrs


def port_reference(ckpt_root, **cfg_kw):
    """The CLI's config, batch 0 and the port's own diverse_metrics on it."""
    saved, model = load_model(str(ckpt_root / "run"), device="cpu")
    cfg = saved.generation_override().replace(
        **{**dict(data_root="", nsample=S, use_pallas=True, n_eval=N_EVAL,
                  n_future=N_EVAL - saved.n_past, batch_size=B), **cfg_kw})
    x = Loader(load_dataset(cfg, seq_len=N_EVAL, split="test"), B,
               shuffle=False, seed=cfg.seed, device="cpu").next_batch(0)
    met = make_rollout_fns(model, cfg).diverse_metrics(
        x, seed=1000 * cfg.seed, device="cpu")
    return cfg, x, {k: v.permute(2, 0, 1).numpy() for k, v in met.items()}


def test_default_path_artifacts_and_scores(ckpt, default_run):
    logs, _ = default_run
    arrs = assert_eval_artifacts(logs)
    _, _, met = port_reference(ckpt[0])
    np.testing.assert_array_equal(arrs["ssim"], met["ssim"])
    np.testing.assert_array_equal(arrs["psnr"], met["psnr"])


def test_gif_columns_match_dvg_tpu_posterior(ckpt, default_run):
    """Columns 0 and 1 of every GIF frame (ground truth, posterior) before
    encoding equal dvg_tpu's add_border of dvg_tpu's clip and posterior."""
    _, jcfg, state = ckpt
    _, held = default_run
    assert len(held) == 2
    cfg = jcfg.generation_override().replace(
        data_root="", n_eval=N_EVAL, n_future=N_EVAL - jcfg.n_past,
        batch_size=B)
    x = np.asarray(JaxLoader(j_load_dataset(cfg, seq_len=N_EVAL,
                                            split="test"), B, shuffle=False,
                             seed=cfg.seed).next_batch(0))
    jmodel = JaxModel(cfg)
    post = np.asarray(j_make_rollout_fns(jmodel, cfg, nsample=S).posterior(
        state.params, state.stats, jmodel.gp_cache(state.params),
        jnp.asarray(x)))
    for i, (path, gifs) in enumerate(held):
        assert path.endswith(f"sample_lstm_{i}.gif")
        assert len(gifs) == N_EVAL
        for t, row in enumerate(gifs):
            assert len(row) == 6
            color = "green" if t < jcfg.n_past else "red"
            np.testing.assert_allclose(row[0], j_add_border(x[t, i], "green"),
                                       atol=1e-4)
            np.testing.assert_allclose(row[1], j_add_border(post[t, i], color),
                                       atol=1e-4)


@pytest.mark.parametrize("flag,kw", [("--finn", dict(eval_metric="finn")),
                                     ("--no_pallas", dict(use_pallas=False))],
                         ids=["finn", "no_pallas"])
def test_metric_route_flags(ckpt, flag, kw):
    root = ckpt[0]
    logs = root / flag.strip("-")
    assert gen_cli.main(cli_args(root / "run", logs, flag)) == 0
    arrs = assert_eval_artifacts(logs)
    _, _, met = port_reference(root, **kw)
    np.testing.assert_array_equal(arrs["ssim"], met["ssim"])
    np.testing.assert_array_equal(arrs["psnr"], met["psnr"])


def test_full_cov_path(ckpt, monkeypatch):
    """--full_cov, with --trace_dir; the f32 run turns TF32 off for itself
    and restores the caller's setting after."""
    root = ckpt[0]
    logs = root / "full_cov"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert gen_cli.main(cli_args(root / "run", logs, "--full_cov",
                                 "--trace_dir", str(logs / "trace"))) == 0
    assert torch.backends.cudnn.allow_tf32 is True
    assert_eval_artifacts(logs)
    with open(logs / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_gp_trigger_path(ckpt, tmp_path, monkeypatch):
    root = ckpt[0]
    logs = root / "trigger"
    monkeypatch.chdir(tmp_path)          # strips are written CWD-relative
    assert gen_cli.main(cli_args(root / "run", logs, "--gp_trigger_flag",
                                 n_eval=14)) == 0
    strips = glob.glob(str(tmp_path / "recursive_generation" / "*" / "*.png"))
    assert len(strips) == B               # one strip per batch row
    recs = read_jsonl(logs / "metrics.jsonl")
    trig = [r for r in recs if r["kind"] == "trigger"]
    assert len(trig) == 1 and np.isfinite(trig[0]["triggers"])


def test_mesh_flags_refused(ckpt):
    """Mesh flags that one process cannot serve are refused, naming the
    fix: --mesh_samples 2 needs two processes (launched by torchrun or the
    DVG_* env; tests/test_torch_dist_cli.py runs them), and --mesh_data
    without --mesh_samples would be ignored."""
    root = ckpt[0]
    for extra, why in ((["--mesh_samples", "2"], "torchrun"),
                       (["--mesh_data", "2"], "requires --mesh_samples")):
        with pytest.raises(SystemExit, match=why):
            gen_cli.main(cli_args(root / "run", root / "mesh", *extra))


def test_no_hidden_device(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    root = ckpt[0]
    args = [a for a in cli_args(root / "run", root / "nodev")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        gen_cli.main(args)


def test_whole_run_without_pil_or_imageio(ckpt, tmp_path):
    """The card's machine has neither PIL nor imageio: a whole CLI run (the
    default path and the trigger path) with both unimportable, and none of
    JAX or dvg_tpu imported either."""
    root = ckpt[0]
    code = textwrap.dedent(f"""
        import sys
        for name in ("PIL", "imageio", "jax", "flax", "dvg_tpu"):
            sys.modules[name] = None
        from dvg_tpu_torch.cli.generate import main
        import dvg_tpu_torch.train, dvg_tpu_torch.cli.train
        base = {cli_args(root / "run", tmp_path / "logs")!r}
        assert main(base) == 0
        assert main(base[:-1] + ["1", "--gp_trigger_flag",
                                 "--override_n_eval", "14"]) == 0
        bad = [m for m in sys.modules if sys.modules[m] is not None and
               m.split(".")[0] in ("PIL", "imageio", "jax", "dvg_tpu")]
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert len(glob.glob(str(tmp_path / "logs" / "sample_lstm_*.gif"))) == 2
    assert len(glob.glob(str(tmp_path / "recursive_generation" / "*"
                             / "*.png"))) == B
