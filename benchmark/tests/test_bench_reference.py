"""The plain reference against the program at tiny widths on the CPU, both
in f32: where the arithmetic is the same precision the two agree to
rounding, so a reading of a run on the card is the program's precision and
not a fault of the reference."""

import pytest
import torch

from benchmark import manifest, weights
from benchmark.drivers import eval as eval_driver
from benchmark.drivers import train as train_driver
from benchmark.reference.noise import fork_noise
from benchmark.tests import cells

TINY = {"g_dim": 8, "rnn_size": 16, "num_inducing_points": 4}
EVAL = {"model": TINY, "nsample": 3, "n_eval": 20, "batch_size": 2,
        "warmup_calls": 1, "dtype": "float32"}
SEED = 2 ** 31 + 11
CHECK = 4          # steps before the window: set-up's three and one more


@pytest.fixture(scope="module")
def m():
    return manifest.load()


def _eval_readings(m, cell, **extra):
    d = eval_driver.Driver(cells.cell(cell), SEED, "cpu",
                           overrides=dict(EVAL, **extra))
    for _ in range(2):
        d.unit()
    d.release()
    return d.readings()


@pytest.mark.parametrize("cell,extra", [
    ("dcgan64_smmnist.eval", {}),
    ("vgg128_rgb.eval", {"n_eval": 8, "nsample": 2}),
])
def test_reference_follows_the_program_in_f32(m, cell, extra):
    r = _eval_readings(m, cell, **extra)
    assert r["ssim_prefork"] < 1e-4 and r["ssim_at_fork"] < 1e-4, r


def test_train_reference_follows_the_program_in_f32(m):
    d = train_driver.Driver(
        manifest.Cell(m, "dcgan64_smmnist.train"), SEED, "cpu",
        overrides={"model": TINY, "batch_size": 4, "n_past": 2,
                   "n_future": 2, "warmup_steps": CHECK - 3,
                   "dtype": "float32"})
    for _ in range(d.CHECK_UNITS):
        d.unit()
    d.release()
    r = d.readings()
    # Adam divides by √v: where a gradient is near zero its f32 rounding
    # moves the update, so the change reads above the loss and gradient
    assert r["loss_gap"] < 1e-3 and r["grad_gap"] < 1e-3, r
    assert r["change_gap"] < 1e-2, r
    assert r["leaves_left_out"] > 0        # the biases under BatchNorm
    # the window's check starts from a warmed state: Adam's moments and the
    # BatchNorm statistics it carries are the reference's start too
    assert len(d.followed) == 2 and d.followed[1].start == CHECK
    assert d.followed[1].init["adam"]["t"]["encoder"] == CHECK


def test_change_gap_holds_the_batchnorm_statistics():
    init = {"w": torch.ones(4), "bn.running_mean": torch.zeros(3)}
    ref = {"losses": [1.0], "m1": {"w": torch.ones(4)},
           "decay": {"w": 0.9},
           "state": {"w": torch.full((4,), 0.9),
                     "bn.running_mean": torch.full((3,), 0.1)}}
    got = dict(ref, state=dict(ref["state"],
                               **{"bn.running_mean": torch.zeros(3)}))
    assert train_driver.step_gaps(ref, ref, init)["change_gap"] == 0
    r = train_driver.step_gaps(got, ref, init)
    assert r["change_gap"] == pytest.approx(1.0)
    assert r["leaves_compared"] == 2
    # from a warmed Adam the first gradient is the moment less what it kept
    m0 = {"w": torch.full((4,), 10.0)}
    ref1 = dict(ref, m1={"w": 0.9 * m0["w"] + 0.1})
    got1 = dict(ref1, m1={"w": 0.9 * m0["w"] + 0.2})
    assert train_driver.step_gaps(got1, ref1, init, m0)["grad_gap"] == \
        pytest.approx(1.0, rel=1e-4)


@pytest.mark.parametrize("model,width", [("dcgan", 64), ("dcgan", 128),
                                         ("vgg", 64), ("vgg", 128)])
def test_weight_layout_is_the_programs_state_dict(model, width):
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.models.dvg import DVGModel
    spec = dict(TINY, model=model, image_width=width, channels=3,
                predictor_rnn_layers=2)
    program = DVGModel(DVGConfig(**spec), device="cpu").state_dict()
    ours = weights.make(spec, "unit_gain", 5, "cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in program.items()}


def test_weights_and_clips_are_pure_functions_of_the_seed():
    from benchmark import data
    spec = dict(TINY, model="dcgan", image_width=64, channels=1,
                predictor_rnn_layers=2)
    a = weights.make(spec, "init", SEED, "cpu")
    b = weights.make(spec, "init", SEED, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c1 = data.moving_mnist(SEED, 2, 6, 3, 2, "cpu")
    c2 = data.moving_mnist(SEED, 2, 6, 3, 2, "cpu")
    assert torch.equal(c1, c2) and c1.shape == (2, 6, 3, 64, 64, 1)
    assert 0.0 <= float(c1.min()) and float(c1.max()) <= 1.0
    assert not torch.equal(c1[0], c1[1])


def test_frozen_fork_noise_is_the_programs():
    from dvg_tpu_torch.models.gp import fork_noise as program_noise
    sids, rows = torch.arange(3)[:, None], torch.arange(4)[None, :]
    for seed in (0, SEED, 2 ** 40 + 3):
        assert torch.equal(fork_noise(seed, sids, 7, rows, 5),
                           program_noise(seed, sids, 7, rows, 5))
