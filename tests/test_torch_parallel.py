"""The port's parallel layer (`dvg_tpu_torch.parallel`) on the CPU over gloo,
at `__graft_entry__._tiny_cfg`'s widths (DCGAN-64, 1 channel, g_dim 16,
rnn 64, 8 inducing points, B 8, T 4):

  * `mesh_layout`'s checks and `make_mesh`'s process-major rank order;
    `distributed_init` as a no-op, under the DVG_* and torchrun env
    contracts, and its refusals (NCCL with more ranks than cards, named
    by message; DVG_MULTIHOST; an unknown backend);
  * one spawn each of 2 and 4 ranks (`dryrun_multiproc`, which holds the
    ranks against the one-process run itself): the f64 data-parallel step
    against one process on the global batch (metrics and gradients within
    1e-10 of their scale, weights, BN statistics and Adam moments within
    1e-10 but for the BN-fed conv biases, whose gradient is rounding), the
    same weights on every rank; the sharded eval on ("sample", 2) and on
    ("sample", 2) × ("data", 2) against the one-process eval (f32, 1e-6;
    PSNR relative), seeded and with explicit eps, at a fork step that
    moves the samples apart; `broadcast_state` of rank 0's stepped TrainState onto fresh
    ones; `read_checkpoint_bytes_synced`, including a failed read on
    rank 0 raising on the peer;
  * the 2-rank step against `dvg_tpu`'s `make_train_step(mesh=
    make_mesh([("data", 2)]))` on two of the 8 virtual CPU devices, in f64
    at tests/test_torch_train.py's tolerances (metrics rtol 1e-9, state
    atol 1e-8, a BN-fed conv bias within one Adam step); both sharded
    evals against `dvg_tpu`'s `shard_diverse_rollout` fed the same eps
    through `noise=` (SSIM 5e-4, PSNR 1e-2 dB, MSE rtol 1e-3, as in
    tests/test_torch_rollout.py);
  * the full_cov guard of `shard_diverse_metrics`;
  * the Loader's per-rank rows against the one-process global batch.

The eval clip is cut to n_past 14, n_eval 16: its second free step is a
fork step, so the sample ids matter at a cheap depth."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.generate.rollout import make_rollout_fns as j_make_rollout_fns
from dvg_tpu.models.dvg import DVGModel as JaxModel
from dvg_tpu.parallel import make_mesh as j_make_mesh
from dvg_tpu.parallel import shard_diverse_rollout
from dvg_tpu.train import step as JS
from dvg_tpu.train.optim import make_optimizers as j_make_optimizers
from dvg_tpu_torch.convert import params_from_jax, params_to_jax
from dvg_tpu_torch.data import Loader
from dvg_tpu_torch.data.moving_mnist import MovingMNIST
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.parallel import (distributed_init, is_coordinator,
                                    mesh_layout, rank_device,
                                    shard_diverse_metrics, world_size)
from dvg_tpu_torch.parallel import dryrun as D
from test_torch_rollout import jax_noise, jax_state
from test_torch_train import jax_state64, noise_bias, perturbed_gp, x64

ROUTE_TOL = dict(ssim=5e-4, psnr=1e-2)     # tests/test_torch_rollout.py
MSE_RTOL = 1e-3
ATOL, LR = 1e-8, 0.002                     # tests/test_torch_train.py
KEY = 2


def jax_eval_cfg(n: int) -> JaxConfig:
    """dvg_tpu's config of the dry run's eval, its metric through the plain
    reference (no Pallas interpret mode): the port's K1 runs its plain
    version on the CPU too."""
    _, evalc = D._cfgs(n)
    return JaxConfig(**dict(evalc.to_dict(), nsample=D.EVAL_S_LOCAL,
                            use_pallas=False))


def jax_mesh_noise(n: int, b: int, d: int) -> np.ndarray:
    """The eps (n_free, S, B, D) of `shard_diverse_rollout`: sample device
    s draws from fold_in(key, s), each row from its global id."""
    n_s = dict(D.mesh_axes(n))["sample"]
    _, evalc = D._cfgs(n)
    n_free = evalc.n_eval - evalc.n_past
    key = jax.random.PRNGKey(KEY)
    return np.concatenate(
        [jax_noise(jax.random.fold_in(key, s), D.EVAL_S_LOCAL, n_free, b, d)
         for s in range(n_s)], axis=1)


@pytest.fixture(scope="module")
def jax_init():
    """The port's seeded init with the GP moved off its init (JAX layout),
    the clip, and the eval's unit-gain weights with a trained-looking GP
    (tests/test_torch_rollout.py's jax_state)."""
    train, _ = D._cfgs(2)
    params, stats = params_to_jax(
        DVGModel(train, device="cpu").state_dict(), train)
    jmodel = JaxModel(jax_eval_cfg(2))
    eparams, estats = jax_state(jmodel, seed=0)
    return dict(params=perturbed_gp(params), stats=stats,
                x=np.random.RandomState(3).rand(4, 8, 64, 64, 1),
                jmodel=jmodel, eparams=eparams, estats=estats,
                x_eval=np.random.RandomState(4).rand(16, 4, 64, 64, 1)
                .astype(np.float32))


def dry(n: int, init) -> dict:
    train, evalc = D._cfgs(n)
    return D.dryrun_multiproc(n, dict(
        state_dict=params_from_jax(init["params"], init["stats"], train),
        x=init["x"],
        eval_state_dict=params_from_jax(init["eparams"], init["estats"],
                                        evalc),
        x_eval=init["x_eval"],
        noise=jax_mesh_noise(n, evalc.batch_size, evalc.g_dim)))


@pytest.fixture(scope="module")
def two(jax_init):
    return dry(2, jax_init)


@pytest.fixture(scope="module")
def four(jax_init):
    return dry(4, jax_init)


# ---------------------------------------------------------------------------
# meshes and process groups
# ---------------------------------------------------------------------------

def test_tiny_cfg_is_graft_entrys():
    j = __graft_entry__._tiny_cfg()
    for k, v in D.TINY.items():
        assert getattr(j, k) == v, k


def test_mesh_layout_and_errors():
    assert mesh_layout(None, 4) == (["data"], [4])
    assert mesh_layout([("sample", 2), ("data", -1)], 8) == (
        ["sample", "data"], [2, 4])
    with pytest.raises(ValueError, match="needs 99 ranks"):
        mesh_layout([("data", 99)], 8)
    with pytest.raises(ValueError, match="sit idle"):
        mesh_layout([("data", 2)], 4)
    with pytest.raises(ValueError, match="divide"):
        mesh_layout([("sample", 3), ("data", -1)], 8)
    with pytest.raises(ValueError, match="-1"):
        mesh_layout([("a", -1), ("b", -1)], 8)


def test_mesh_places_ranks_process_major(two, four):
    """Rank s·D + d sits at (sample s, data d), as dvg_tpu's make_mesh
    reshapes jax.devices()."""
    assert [r["coordinate"] for r in four["ranks"]] == [
        [0, 0], [0, 1], [1, 0], [1, 1]]
    assert [r["coordinate"] for r in two["ranks"]] == [[0], [1]]


def test_distributed_init_noop(monkeypatch):
    for k in ("DVG_COORDINATOR", "DVG_MULTIHOST", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed_init(device="cpu") is False
    assert is_coordinator() and world_size() == 1
    assert rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("contract", ["dvg", "torchrun"])
def test_distributed_init_env_contracts(monkeypatch, contract):
    """Either contract starts a (one-rank) gloo group; a second call is a
    no-op that reports it."""
    port = str(D.free_port())
    if contract == "dvg":
        monkeypatch.setenv("DVG_COORDINATOR", f"localhost:{port}")
        monkeypatch.setenv("DVG_NUM_PROCESSES", "1")
        monkeypatch.setenv("DVG_PROCESS_ID", "0")
    else:
        monkeypatch.delenv("DVG_COORDINATOR", raising=False)
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                     ("MASTER_ADDR", "localhost"), ("MASTER_PORT", port)):
            monkeypatch.setenv(k, v)
    import torch.distributed as dist
    try:
        assert distributed_init(device="cpu") is True
        assert dist.get_backend() == "gloo" and world_size() == 1
        assert is_coordinator() and distributed_init(device="cpu") is True
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_distributed_init_refusals(monkeypatch):
    """NCCL with more ranks on a host than cards raises and names the gloo
    flag (a CPU box has no card at all); DVG_MULTIHOST and unknown
    backends raise; nothing falls back quietly."""
    monkeypatch.setenv("DVG_COORDINATOR", "localhost:1")
    monkeypatch.setenv("DVG_NUM_PROCESSES", "2")
    monkeypatch.setenv("DVG_PROCESS_ID", "0")
    with pytest.raises(ValueError, match="--dist_backend gloo"):
        distributed_init(device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="nccl backend needs device cuda"):
        distributed_init(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend must be one of"):
        distributed_init(device="cpu", backend="mpi")
    monkeypatch.delenv("DVG_COORDINATOR")
    monkeypatch.setenv("DVG_MULTIHOST", "1")
    with pytest.raises(ValueError, match="Cloud TPU"):
        distributed_init(device="cpu")


# ---------------------------------------------------------------------------
# the data-parallel step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_one_process(two, four, n):
    out = {2: two, 4: four}[n]
    errs = out["step_errors"]
    assert max(errs.values()) <= 0, errs
    assert all(r["state_equal_on_ranks"] for r in out["ranks"])
    # broadcast_state put rank 0's stepped state (weights, BN statistics,
    # Adam moments, counts, step) on every rank's fresh, perturbed one
    assert all(r["broadcast_equal"] for r in out["ranks"])
    got, ref = out["ranks"][0]["step"], out["ref_step"]
    # every pass ran and moved its group
    assert set(got["metrics"]) == set(ref["metrics"]) >= {
        "loss", "max_ll", "ft_mse_latent", "ft_gp_nll"}
    for k in ("encoder.head.conv.weight", "frame_predictor.cells.0.weight_hh",
              "gp.z"):
        assert float(got["grads"][k].abs().max()) > 1e-6, k


def test_dp_step_matches_dvg_tpu_mesh_step(two, jax_init):
    """The port's 2-rank step against dvg_tpu's shard_map step over a
    ("data", 2) mesh, from the same f64 init and batch."""
    jcfg = __graft_entry__._tiny_cfg()
    model, opts = JaxModel(jcfg), j_make_optimizers(jcfg)
    with x64():
        mesh = j_make_mesh([("data", 2)])
        step = JS.make_train_step(model, jcfg, opts, mesh=mesh)
        new, metrics = step(jax_state64(jcfg, opts, jax_init["params"],
                                        jax_init["stats"]),
                            jnp.asarray(jax_init["x"]))
        new = jax.tree.map(np.asarray, new)
        metrics = {k: float(v) for k, v in metrics.items()}
    train, _ = D._cfgs(2)
    got = two["ranks"][0]["step"]
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-9,
                                   err_msg=k)
    want = params_from_jax(new.params, new.stats, train)
    bias_d = {}
    for k, v in want.items():
        if "num_batches" in k:
            continue
        d = (got["state_dict"][k] - v.double()).abs()
        if noise_bias(k):
            assert float(d.max()) <= LR, k
            bias_d[k.replace("conv.bias", "bn.running_mean")] = d
        elif k in bias_d:
            assert bool((d <= bias_d[k] + ATOL).all()), k
        else:
            assert float(d.max()) <= ATOL, (k, float(d.max()))
    for i, moment in enumerate(("mu", "nu")):
        merged = {g: getattr(new.opt_states[g][0], moment)
                  for g in ("frame_predictor", "encoder", "decoder")}
        merged.update(getattr(new.opt_states["gp_group"][0], moment))
        want_m = params_from_jax(merged, new.stats, train)
        for k, v in want_m.items():
            if k in got["moments"]:
                np.testing.assert_allclose(got["moments"][k][i].numpy(),
                                           v.double().numpy(), rtol=0,
                                           atol=ATOL, err_msg=(moment, k))


# ---------------------------------------------------------------------------
# the sharded eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_sharded_eval_matches_one_process(two, four, n):
    """Every rank gathers the one-process (S, n_free, B) metrics, seeded
    and with explicit eps; the fork step moves the samples apart by far
    more than the tolerance, so a wrong sample or row offset fails."""
    out = {2: two, 4: four}[n]
    assert max(out["eval_errors"]) <= D.EVAL_TOL
    ref = out["ref_eval_seeded"]
    _, evalc = D._cfgs(n)
    assert ref["ssim"].shape == (evalc.nsample, 2, evalc.batch_size)
    assert float(ref["mse"][:, 0].std(0).max()) == 0.0   # before the fork
    spread = ref["ssim"][:, 1].max(0).values - ref["ssim"][:, 1].min(0).values
    assert float(spread.min()) > 1e3 * D.EVAL_TOL


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_eval_matches_dvg_tpu(two, four, jax_init, n):
    """dvg_tpu's shard_diverse_rollout on the same weights and clip, its
    per-device eps fed to the port through noise=."""
    out = {2: two, 4: four}[n]
    jcfg = jax_eval_cfg(n)
    jmodel = jax_init["jmodel"]
    local = j_make_rollout_fns(jmodel, jcfg, nsample=D.EVAL_S_LOCAL)
    axes = D.mesh_axes(n)
    mesh = j_make_mesh(axes, devices=jax.devices()[:n])
    fn = shard_diverse_rollout(local.diverse_metrics, mesh,
                               data_axis="data" if len(axes) == 2 else None)
    p, s = jax_init["eparams"], jax_init["estats"]
    ref = fn(p, s, jmodel.gp_cache(p), jnp.asarray(jax_init["x_eval"]),
             jax.random.PRNGKey(KEY))
    got = out["ranks"][-1]["eval_noise"]
    for k, tol in ROUTE_TOL.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=tol, err_msg=k)
    np.testing.assert_allclose(got["mse"].numpy(), np.asarray(ref["mse"]),
                               rtol=MSE_RTOL)
    # the fork step spreads the samples' MSE by far more than its tolerance
    mse = np.asarray(ref["mse"])[:, 1]
    assert (np.ptp(mse, axis=0) / mse.mean(0)).min() > 10 * MSE_RTOL


def test_full_cov_guard():
    """Full-covariance sampling correlates the draw across the whole batch:
    a data axis above 1 raises at the mechanism; a data axis of 1 and a
    pure sample mesh stay legal. (A DeviceMesh-shaped stand-in: the guard
    reads only the axes.)"""
    def mesh(names, sizes):
        return SimpleNamespace(
            mesh_dim_names=names,
            mesh=torch.arange(int(np.prod(sizes))).reshape(sizes),
            get_coordinate=lambda: [0] * len(sizes))
    fns = SimpleNamespace(nsample=2)
    with pytest.raises(ValueError, match="full_cov"):
        shard_diverse_metrics(fns, mesh(("sample", "data"), (2, 2)),
                              full_cov=True)
    shard_diverse_metrics(fns, mesh(("sample", "data"), (4, 1)),
                          full_cov=True)
    shard_diverse_metrics(fns, mesh(("sample",), (4,)), full_cov=True)
    shard_diverse_metrics(fns, mesh(("sample", "data"), (2, 2)))
    with pytest.raises(ValueError, match="'sample' and/or 'data'"):
        shard_diverse_metrics(fns, mesh(("model",), (4,)))


# ---------------------------------------------------------------------------
# checkpoint reads and the loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_synced_checkpoint_read(two, four, n):
    """Every rank holds rank 0's bytes although only rank 0's path exists,
    and a failed read on rank 0 raises on every peer."""
    ranks = {2: two, 4: four}[n]["ranks"]
    assert len({len(r["ckpt_bytes"]) for r in ranks}) == 1
    assert all(r["ckpt_bytes"] == ranks[0]["ckpt_bytes"] for r in ranks)
    assert [r["ckpt_missing"] for r in ranks] == (
        ["FileNotFoundError"] + ["RuntimeError"] * (n - 1))


class Items:
    """An indexable dataset: item i is a (T, H, W, 1) clip filled with i."""
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return np.full((3, 4, 4, 1), i, np.float32), 0


@pytest.mark.parametrize("source", ["items", "sample_batch", "device_batch"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_rows_per_rank(tmp_path, source, shuffle):
    """The ranks' rows, concatenated in rank order, are the one-process
    global batch, step after step."""
    ds = (Items() if source == "items" else
          MovingMNIST(train=True, data_root=str(tmp_path), seq_len=4))
    dev = "cpu" if source == "device_batch" else None
    one = Loader(ds, 6, shuffle=shuffle, seed=3, num_threads=1, device=dev)
    ranks = [Loader(ds, 6, shuffle=shuffle, seed=3, num_threads=1,
                    device=dev, rank=r, world=3) for r in range(3)]
    for step in (0, 5):
        want = np.asarray(one.next_batch(step))
        got = [np.asarray(ld.next_batch(step)) for ld in ranks]
        assert all(g.shape[1] == 2 for g in got)
        np.testing.assert_array_equal(np.concatenate(got, axis=1), want)
    with pytest.raises(ValueError, match="does not divide"):
        Loader(ds, 7, rank=0, world=2)
    with pytest.raises(ValueError, match="outside"):
        Loader(ds, 8, rank=2, world=2)
