"""The port's checkpoint bridge against `dvg_tpu`'s own format: a
`dvg_tpu` TrainState saved by `dvg_tpu.train.checkpoint.save_checkpoint`
loads in `dvg_tpu_torch.checkpoint` with every leaf bit-equal after the
layout maps; the port's msgpack re-encoding of the decoded payload, and a
re-save through the model, are byte-identical to the file; a port-written
file reads back in flax and in `dvg_tpu` with equal leaves and config. The
port's msgpack refuses what the format does not hold. msgpack and flax are
used here only, as the reference."""

import json
import os

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from dvg_tpu.config import DVGConfig as JaxConfig
from dvg_tpu.train import checkpoint as jckpt
from dvg_tpu.train.step import init_train_state
from dvg_tpu_torch import _msgpack
from dvg_tpu_torch.checkpoint import (load_checkpoint, load_model,
                                      save_checkpoint)
from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import params_from_jax, params_to_jax
from dvg_tpu_torch.models.dvg import DVGModel

GEOM = dict(dataset="smmnist", channels=1, image_width=64, batch_size=2,
            n_past=2, n_future=1, n_eval=4, g_dim=8, rnn_size=16,
            num_inducing_points=4, epoch_size=3)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict/list pytree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _flat(params, stats):
    return {**_leaves(params, "/params"), **_leaves(stats, "/stats")}


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    cfg = JaxConfig(**GEOM)
    _, state, _ = init_train_state(cfg, jax.random.PRNGKey(0))
    path = jckpt.save_checkpoint(str(tmp_path_factory.mktemp("jax")), cfg,
                                 state)
    params = jax.tree.map(np.asarray, state.params)
    stats = jax.tree.map(np.asarray, state.stats)
    with open(path, "rb") as f:
        return path, f.read(), cfg, params, stats


def test_dvg_tpu_checkpoint_loads_bit_equal(jax_file):
    path, _, jcfg, params, stats = jax_file
    cfg, sd, payload = load_checkpoint(os.path.dirname(path))
    assert cfg.to_dict() == jcfg.to_dict()
    ref = params_from_jax(params, stats, cfg)
    assert sd.keys() == ref.keys()
    for k in sd:
        assert sd[k].dtype == ref[k].dtype and torch.equal(sd[k], ref[k]), k
    # and back: the inverse maps give the JAX leaves bit for bit
    got, want = _flat(*params_to_jax(sd, cfg)), _flat(params, stats)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the model carries them
    model = DVGModel(cfg, device="cpu")
    model.load_state_dict(sd)
    assert torch.equal(model.gp.var_chol,
                       torch.tensor(np.asarray(params["gp"]["var_chol"])))


def test_reencoding_is_byte_identical(jax_file, tmp_path):
    path, blob, *_ = jax_file
    assert _msgpack.packb(_msgpack.unpackb(blob)) == blob
    # a re-save through the model, carrying opt_states and step through
    cfg, model = load_model(path, device="cpu")
    _, _, payload = load_checkpoint(path)
    out = save_checkpoint(str(tmp_path / "again.ckpt"), cfg, model, payload)
    with open(out, "rb") as f:
        assert f.read() == blob


def test_port_written_file_reads_in_flax_and_dvg_tpu(tmp_path):
    cfg = DVGConfig(**GEOM)
    model = DVGModel(cfg, seed=3, device="cpu")
    path = save_checkpoint(str(tmp_path / "run"), cfg, model)
    assert path == str(tmp_path / "run" / "model.ckpt")
    with open(path, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    assert DVGConfig.from_dict(json.loads(payload["config"])) == cfg
    assert payload["opt_states"] == {} and int(payload["step"]) == 0
    # flax keeps lists as {"0": ...} maps: the same key paths as _flat's
    want = _flat(*params_to_jax(model.state_dict(), cfg))
    got = _flat(payload["params"], payload["stats"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jcfg, _ = jckpt.load_checkpoint(str(tmp_path / "run"))
    assert jcfg == JaxConfig(**GEOM)
    # and back into the port: the same weights
    _, sd, _ = load_checkpoint(path)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k


def test_generation_override_matches_jax():
    cfg = DVGConfig(**GEOM)
    g = cfg.generation_override()
    assert (g.n_eval, g.n_future, g.batch_size) == (105, 100, 50)
    assert g.n_past == cfg.n_past and cfg.n_eval == GEOM["n_eval"]
    assert g.to_dict() == JaxConfig(**GEOM).generation_override().to_dict()


@pytest.mark.parametrize("blob,match", [
    (serialization.msgpack_serialize({"a": complex(1, 2)}), "extension"),
    (serialization.msgpack_serialize({"a": np.zeros(2, np.float32)})[:-3],
     "truncated"),
    (b"\x81\xa1a\xca\x3f\x80\x00\x00", "0xca"),             # float32
    (b"\xc0\xc0", "trailing"),
    (_msgpack.packb({_msgpack.CHUNKED_MARKER: True}), "chunked"),
])
def test_msgpack_refuses_what_the_format_does_not_hold(blob, match):
    with pytest.raises(_msgpack.MsgpackError, match=match):
        _msgpack.unpackb(blob)


def test_msgpack_matches_flax_encoding():
    tree = {"ints": [0, 127, 128, -1, -32, -33, 255, 256, -129, 70000,
                     -70000, 2 ** 40, -2 ** 40],
            "f": 1.5, "none": None, "flags": [True, False],
            "s": "x" * 40, "b": b"y" * 300, "scalar": np.float32(3),
            "arr": np.arange(6, dtype=np.int32).reshape(2, 3),
            "wide": {k: int(k) for k in sorted(map(str, range(20)))}}
    tree = {k: tree[k] for k in sorted(tree)}      # flax writes sorted maps
    blob = serialization.msgpack_serialize(tree)
    assert _msgpack.packb(tree) == blob
    back = _msgpack.unpackb(blob)
    assert back["ints"] == tree["ints"] and back["s"] == tree["s"]
    assert isinstance(back["scalar"], np.float32)
    np.testing.assert_array_equal(back["arr"], tree["arr"])
