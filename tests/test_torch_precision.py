"""experiments/tpu_precision.py's `xla_bias_sum()` against dvg_tpu on the
CPU: the port's train step with dvg_tpu's bf16 output-bias gradient.

  * `xla_cpu_sum` equals XLA:CPU's own bf16 reduce_sum, bit for bit, on the
    same cotangent: the vjp of dvg_tpu's bias add (`y + b.astype(bf16)`,
    dvg_tpu/models/dcgan.py:192) over decoder-shaped (calls, B, H, W, C)
    arrays, strided as the port's NCHW cotangent is;
  * at tests/test_torch_train.py's tiny geometry (T 3, B 2, g_dim 8,
    rnn 16) in bf16, on one procedural batch and one seeded init:
    - the forward is bit-equal with and without the emulation (the loss and
      its metrics);
    - the port's output-bias gradient lies within BIAS_F32 of its f32
      gradient without it, and within BIAS_JAX of dvg_tpu's bf16 gradient
      with it (measured 5.9e-4 and 1.3e-2; dvg_tpu's own lies 31% off
      f32 here, over 4·BIAS_JAX);
    - every other gradient is unchanged, bit for bit.

`xla_bias_sum()` patches the port's decoder class; monkeypatch puts it
back after each test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.models import dcgan
from dvg_tpu_torch.models.dvg import DVGModel
from train_side_by_side import (first_train_batch, jax_grads, port_pass,
                                tpu_precision)

GEOM = dict(dataset="smmnist", channels=1, image_width=64, batch_size=2,
            n_past=2, n_future=1, n_eval=3, g_dim=8, rnn_size=16,
            num_inducing_points=4, ft=True, data_root="", seed=1)
BIAS_F32, BIAS_JAX = 5e-3, 5e-2
KEY = "decoder.final.bias"


@pytest.fixture
def experiment(monkeypatch):
    monkeypatch.setattr(dcgan.Decoder, "grouped", dcgan.Decoder.grouped)
    return tpu_precision()


@pytest.mark.parametrize("shape", [(42, 8, 64, 64, 1), (41, 100, 64, 64, 1),
                                   (6, 2, 64, 64, 3)])
def test_xla_cpu_sum_is_xla_cpus(experiment, shape):
    """Cotangents of decoder scale (mean 2e-4, std 1e-3, where bf16 partial
    sums stall), laid out NCHW as the port's are, then viewed (calls, B,
    H, W, C)."""
    rng = np.random.default_rng(sum(shape))
    g = jnp.asarray(rng.normal(2e-4, 1e-3, shape), jnp.bfloat16)
    _, vjp = jax.vjp(lambda b: jnp.zeros(shape, jnp.bfloat16)
                     + b.astype(jnp.bfloat16),
                     jnp.zeros(shape[-1:], jnp.float32))
    want = np.asarray(jax.jit(vjp)(g)[0])
    nchw = torch.from_numpy(np.array(g.astype(jnp.float32))).to(
        torch.bfloat16).flatten(0, 1).permute(0, 3, 1, 2).contiguous()
    got = experiment.xla_cpu_sum(
        nchw.unflatten(0, shape[:2]).permute(0, 1, 3, 4, 2))
    exact = np.asarray(g.astype(jnp.float32), np.float64).sum((0, 1, 2, 3))
    assert got.dtype == torch.bfloat16 and got.shape == shape[-1:]
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.abs(want - exact).max() > 0.5 * np.abs(exact).max()


def test_xla_bias_sum_gives_dvg_tpus_bias_gradient(experiment):
    cfg32, cfg = (DVGConfig(**GEOM, dtype=dt)
                  for dt in ("float32", "bfloat16"))
    state_dict = DVGModel(cfg, seed=GEOM["seed"], device="cpu").state_dict()
    x = first_train_batch(cfg, cfg.batch_size, cfg.seed)
    _, want = port_pass(state_dict, cfg32, x)
    out, plain = port_pass(state_dict, cfg, x)
    jax_g = jax_grads(state_dict, cfg, x)[KEY]
    experiment.xla_bias_sum()
    emu_out, emu = port_pass(state_dict, cfg, x)

    def dist(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    print(f"{KEY} gradient, bf16: port {dist(plain[KEY], want[KEY]):.2e} off "
          f"f32, dvg_tpu {dist(jax_g, want[KEY]):.2e} off f32; under "
          f"xla_bias_sum {dist(emu[KEY], jax_g):.2e} off dvg_tpu's")
    assert out.keys() == emu_out.keys()
    for k in out:
        assert torch.equal(out[k], emu_out[k]), k
    assert dist(plain[KEY], want[KEY]) <= BIAS_F32
    assert dist(emu[KEY], jax_g) <= BIAS_JAX
    assert dist(jax_g, want[KEY]) > 4 * BIAS_JAX
    for k in plain:
        if k != KEY:
            assert torch.equal(plain[k], emu[k]), k
