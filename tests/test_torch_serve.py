"""The port's serving export (`dvg_tpu_torch.serve`) on the CPU, from one
`dvg_tpu` checkpoint at a tiny width (DCGAN-64, 1 channel, g_dim 8, rnn
16, 4 inducing points, B 2, S 4, n_past 14, n_eval 16: the second free
step, 15, is a fork step, so the seed input matters at a cheap depth, and
gp_trigger runs 4 decision steps after its 12-step warm-up):

  * each entry exported to a `.pt2` once (module fixture), loaded by
    `load_serving` and called: equal to the port's live entry on the same
    seed (f32, atol 1e-6; gp_trigger's masks equal), and a changed seed
    changes the futures; the diverse_metrics program holds one
    `dvg_tpu_torch::ssim_cyclic` node (K1) per free-run step;
  * the posterior artifact against `dvg_tpu`'s exported and loaded
    posterior artifact from the same checkpoint, frames atol 1e-4 (the
    posterior parity tolerance of tests/test_torch_generate.py);
  * `fork_noise` with a 0-dim int64 tensor seed bit-equal to the int seed;
  * the sidecar's keys, `dvg_tpu`'s and the graph's node count;
  * a fresh process that loads and calls an artifact imports nothing of
    the port's models or generation code, nor JAX; the slice's modules
    import with JAX and `dvg_tpu` made unimportable;
  * both custom ops through `torch.library.opcheck`;
  * the refusals (tests/test_serve.py's, a CUDA artifact without a card,
    a sharded artifact without a process group);
  * a ("sample", 2) artifact on 2 gloo ranks (`parallel.dryrun.
    serve_multiproc`, one spawn) equal to the one-process artifact."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.serve import export_serving as j_export_serving
from dvg_tpu.serve import load_serving as j_load_serving
from dvg_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from dvg_tpu.train.step import init_train_state
from dvg_tpu_torch.checkpoint import load_model, save_checkpoint
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.generate.rollout import make_rollout_fns
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.models.gp import fork_noise
from dvg_tpu_torch.ops import ssim_cuda
from dvg_tpu_torch.parallel.dryrun import serve_multiproc
from dvg_tpu_torch.serve import export_serving, load_serving

ROOT = Path(__file__).resolve().parent.parent
GEOM = dict(nsample=4, batch_size=2, n_eval=16)
CFG = JaxConfig(dataset="smmnist", channels=1, image_width=64, n_past=14,
                n_future=2, g_dim=8, rnn_size=16, num_inducing_points=4,
                use_pallas=True, **GEOM)
ENTRIES = ("posterior", "diverse_metrics", "gp_trigger")
ATOL = 1e-6
FRAME_ATOL = 1e-4          # tests/test_torch_generate.py's posterior check
SEED = 9
SIDECAR_KEYS = {"entry", "config", "platforms", "in_shapes", "mesh_samples",
                "mesh_data", "nr_devices", "bytes", "nodes"}


def _x() -> np.ndarray:
    return np.random.RandomState(5).rand(16, 2, 64, 64, 1).astype(np.float32)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve") / "model")
    # jitted: one compile, where the eager init dispatches op by op (~3x
    # slower on the CPU)
    state = jax.jit(lambda k: init_train_state(CFG, k)[1])(
        jax.random.PRNGKey(0))
    j_save_checkpoint(d, CFG, state)
    return d


@pytest.fixture(scope="module")
def served(ckpt, tmp_path_factory):
    """Each entry exported once, loaded once → {entry: (path, callable)}."""
    d = tmp_path_factory.mktemp("artifacts")
    out = {}
    for entry in ENTRIES:
        path = export_serving(ckpt, str(d / f"{entry}.pt2"), entry=entry,
                              device="cpu", **GEOM)
        out[entry] = path, load_serving(path)
    return out


@pytest.fixture(scope="module")
def live(ckpt):
    """The port's live entries at the artifacts' geometry."""
    saved, model = load_model(ckpt, device="cpu")
    cfg = saved.generation_override().replace(
        n_future=GEOM["n_eval"] - saved.n_past, **GEOM)
    return make_rollout_fns(model, cfg)


def _equal(got, ref, atol=ATOL):
    if isinstance(ref, torch.Tensor):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        if ref.dtype == torch.bool:
            assert torch.equal(got, ref)
        else:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=atol,
                                       rtol=0)
    elif isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _equal(got[k], ref[k], atol)
    else:
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _equal(g, r, atol)


@pytest.mark.parametrize("entry", ENTRIES)
def test_artifact_equals_live_entry(served, live, entry):
    x = _x()
    fn = served[entry][1]
    if entry == "posterior":
        _equal(fn(x), live.posterior(x, device="cpu"))
        return
    got = fn(x, SEED)
    _equal(got, getattr(live, entry)(x, seed=SEED, device="cpu"))
    # the seed is an input of the program, not a constant of it
    other = fn(x, SEED + 1)
    frames = (lambda o: o["ssim"]) if entry == "diverse_metrics" else \
        (lambda o: o[0])
    assert not torch.equal(frames(got), frames(other))


def test_metrics_program_holds_k1_per_step(served):
    path = served["diverse_metrics"][0]
    program = torch.export.load(path)
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and "ssim_cyclic" in str(n.target)]
    assert len(nodes) == GEOM["n_eval"] - CFG.n_past
    side = json.loads(Path(path + ".json").read_text())
    assert side["nodes"] == len(program.graph.nodes)


def test_posterior_equals_dvg_tpus_artifact(ckpt, served, tmp_path):
    out = str(tmp_path / "posterior.stablehlo")
    j_export_serving(ckpt, out, entry="posterior", **GEOM)
    x = _x()
    ref = np.asarray(j_load_serving(out)(x))
    got = served["posterior"][1](x).numpy()
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**32 + 5, 2**40, -7])
def test_fork_noise_tensor_seed_is_the_int_seed(seed):
    ids = (torch.arange(3)[:, None], torch.arange(4)[None, :])
    want = fork_noise(seed, ids[0], 15, ids[1], 8)
    got = fork_noise(torch.tensor(seed, dtype=torch.int64), ids[0], 15,
                     ids[1], 8)
    assert torch.equal(got, want)


def test_sidecar(served):
    path = served["diverse_metrics"][0]
    side = json.loads(Path(path + ".json").read_text())
    assert set(side) == SIDECAR_KEYS
    assert side["entry"] == "diverse_metrics"
    assert side["platforms"] == ["cpu"]
    assert side["in_shapes"] == [[16, 2, 64, 64, 1], []]
    assert (side["mesh_samples"], side["mesh_data"],
            side["nr_devices"]) == (None, None, 1)
    assert side["bytes"] == os.path.getsize(path)
    assert side["config"]["nsample"] == 4 and side["config"]["n_eval"] == 16
    post = json.loads(Path(served["posterior"][0] + ".json").read_text())
    assert post["in_shapes"] == [[16, 2, 64, 64, 1]]


def test_loading_imports_no_model_code(served, tmp_path):
    """A serving host needs the artifact and the op registration only.
    Then, in the same process with JAX and `dvg_tpu` made unimportable,
    the slice's other modules import and run (the package rule)."""
    np.save(tmp_path / "x.npy", _x())
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "flax", "msgpack", "dvg_tpu"):
            sys.modules[name] = None
        import numpy as np
        from dvg_tpu_torch.serve import load_serving
        served = load_serving({served['diverse_metrics'][0]!r})
        out = served(np.load({str(tmp_path / 'x.npy')!r}), {SEED})
        assert out["ssim"].shape == (4, 2, 2), out["ssim"].shape
        bad = [m for m in sys.modules if sys.modules[m] is not None and (
               m.split(".")[0] in ("jax", "dvg_tpu") or m.startswith(
                   ("dvg_tpu_torch.models", "dvg_tpu_torch.generate")))]
        print("IMPORTED", bad)
        import torch
        import dvg_tpu_torch.serve.export
        from dvg_tpu_torch.models.classifiers import MLP2
        from dvg_tpu_torch.models.rnn import GRUPredictor
        from dvg_tpu_torch.models.vgg import GaussianEncoder
        assert MLP2()(torch.ones(2, 10)).shape == (2, 6)
        print("MODULES OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "IMPORTED []" in res.stdout, res.stdout
    assert "MODULES OK" in res.stdout, res.stdout


@pytest.mark.parametrize("op", ["ssim_cyclic", "ssim_images"])
def test_custom_op_opcheck(op):
    g = torch.Generator().manual_seed(3)
    gt = torch.rand((2, 16, 16, 3), generator=g)
    pred = torch.rand((4 if op == "ssim_cyclic" else 2, 16, 16, 3),
                      generator=g)
    torch.library.opcheck(getattr(torch.ops.dvg_tpu_torch, op).default,
                          (gt, pred))
    want = (ssim_cuda.ssim_psnr_batch_cyclic if op == "ssim_cyclic" else
            ssim_cuda.ssim_psnr_batch_images)(gt, pred)
    assert want.shape == (3, pred.shape[0]) and want.dtype == torch.float32


def test_export_refusals(ckpt, tmp_path):
    """tests/test_serve.py's refusals of `dvg_tpu`'s exporter, with its
    messages, and a default-device export without a card."""
    with pytest.raises(ValueError, match="diverse_metrics"):
        export_serving(ckpt, str(tmp_path / "x.pt2"), entry="posterior",
                       mesh_samples=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        export_serving(ckpt, str(tmp_path / "y.pt2"),
                       entry="diverse_metrics", nsample=3, mesh_samples=2,
                       device="cpu")
    with pytest.raises(ValueError, match="requires mesh_samples"):
        export_serving(ckpt, str(tmp_path / "z.pt2"),
                       entry="diverse_metrics", mesh_data=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        export_serving(ckpt, str(tmp_path / "w.pt2"),
                       entry="diverse_metrics", nsample=4, batch_size=3,
                       mesh_samples=2, mesh_data=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            export_serving(ckpt, str(tmp_path / "v.pt2"))


def test_full_cov_refuses_mesh_data(tmp_path):
    cfg_fc = DVGConfig.from_dict(dict(CFG.to_dict(), full_cov_sampling=True))
    d = save_checkpoint(str(tmp_path / "model_fc"), cfg_fc,
                        DVGModel(cfg_fc, device="cpu"))
    with pytest.raises(ValueError, match="full_cov"):
        export_serving(d, str(tmp_path / "z.pt2"), entry="diverse_metrics",
                       nsample=4, batch_size=2, mesh_samples=2, mesh_data=2,
                       device="cpu")


def test_load_refusals(served, tmp_path):
    """A CUDA artifact without a card, and a sharded artifact without a
    process group of its size, raise instead of running elsewhere."""
    for suffix, entry, patch in (
            ("cuda", "posterior", {"platforms": ["cuda"]}),
            ("mesh", "diverse_metrics", {"mesh_samples": 2, "mesh_data": 2})):
        src = served[entry][0]
        path = str(tmp_path / f"{suffix}.pt2")
        shutil.copy(src, path)
        side = json.loads(Path(src + ".json").read_text())
        Path(path + ".json").write_text(json.dumps(dict(side, **patch)))
        if suffix == "cuda" and torch.cuda.is_available():
            continue
        match = "torch.cuda is not available" if suffix == "cuda" else \
            "process group of 4 ranks"
        with pytest.raises(RuntimeError, match=match):
            load_serving(path)


def test_sharded_artifact_on_two_ranks(ckpt, served, tmp_path):
    """One spawn of 2 gloo ranks: the ("sample", 2) artifact, S 2 per
    rank, gathered on each rank, against the one-process artifact of S 4;
    the ranks import no model code."""
    sharded = export_serving(ckpt, str(tmp_path / "sharded.pt2"),
                             entry="diverse_metrics", device="cpu",
                             mesh_samples=2, **GEOM)
    side = json.loads(Path(sharded + ".json").read_text())
    assert side["in_shapes"] == [[16, 2, 64, 64, 1], [], [], []]
    assert (side["mesh_samples"], side["nr_devices"]) == (2, 2)
    x = _x()
    want = served["diverse_metrics"][1](x, SEED)
    ranks = serve_multiproc(sharded, 2, x, SEED)
    for r in ranks:
        assert r["modules"] == []
        _equal(r["metrics"], want)
