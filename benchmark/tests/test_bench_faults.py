"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run past the look for a card (`run_cell`
on the CPU, tiny widths, f32), first as it is, which comes out correct,
then with one fault the cell can have planted in the program: an answer
altered where it is produced (eval: one step's scores from K1), a step
that sees half its batch, a step that returns its state unchanged (from
the first step, or only in the window, as a step captured after set-up
would), a step that hands back a stale loss."""

import contextlib

import pytest
import torch

from benchmark import control, run
from benchmark.drivers import train as train_driver
from benchmark.tests import cells

TINY = {"g_dim": 8, "rnn_size": 16, "num_inducing_points": 4}
OVERRIDES = {
    "vgg128_rgb.eval": {"model": dict(TINY, image_width=64), "nsample": 3,
                        "n_eval": 17, "batch_size": 2, "warmup_calls": 1,
                        "dtype": "float32"},
    "dcgan64_smmnist.train": {"model": TINY, "batch_size": 4, "n_past": 2,
                              "n_future": 2, "warmup_steps": 0,
                              "dtype": "float32"},
}


@contextlib.contextmanager
def k1_altered(monkeypatch):
    """K1's scores of every call's first step off by 0.05 SSIM."""
    from dvg_tpu_torch.generate import rollout
    original = rollout.ssim_psnr_batch_cyclic
    calls = {"n": 0}

    def altered(gt, pred):
        out = original(gt, pred)
        calls["n"] += 1
        if calls["n"] % (OVERRIDES["vgg128_rgb.eval"]["n_eval"] - 5) == 1:
            out = out.clone()
            out[0] += 0.05
        return out
    monkeypatch.setattr(rollout, "ssim_psnr_batch_cyclic", altered)
    yield


@contextlib.contextmanager
def unchanged_in_window(monkeypatch):
    """Steps after set-up's check and warm-up leave the state unchanged."""
    from dvg_tpu_torch.train import step as step_mod
    original = step_mod.make_train_step
    set_up = train_driver.CHECK_STEPS + OVERRIDES[
        "dcgan64_smmnist.train"]["warmup_steps"]

    def broken(cfg, group=None):
        step_fn, seen = original(cfg, group), {"n": 0}

        def faulty(state, x):
            seen["n"] += 1
            if seen["n"] <= set_up:
                return step_fn(state, x)
            kept = {k: v.clone() for k, v in state.model.state_dict().items()}
            state, metrics = step_fn(state, x)
            state.model.load_state_dict(kept)
            return state, metrics
        return faulty
    monkeypatch.setattr(step_mod, "make_train_step", broken)
    yield


def _run(name, seed=2 ** 31 + 99):
    cell = cells.cell(name)
    res, code = run.run_cell(cell, seed, 0.2, False, "cpu",
                             overrides=OVERRIDES[name])
    assert code == 0
    return res


@pytest.mark.parametrize("name", sorted(OVERRIDES))
def test_sound_tiny_run_is_correct(name):
    res = _run(name)
    assert res["checks"] and res["correct"], res["checks"]


@pytest.mark.parametrize("name,fault", [
    ("vgg128_rgb.eval", "k1_altered"),
    ("dcgan64_smmnist.train", "half_batch"),
    ("dcgan64_smmnist.train", "unchanged"),
    ("dcgan64_smmnist.train", "unchanged_in_window"),
    ("dcgan64_smmnist.train", "stale_loss"),
])
def test_fault_makes_the_run_incorrect(monkeypatch, name, fault):
    plant = {"k1_altered": lambda: k1_altered(monkeypatch),
             "unchanged_in_window": lambda: unchanged_in_window(
                 monkeypatch)}.get(
        fault, lambda: control.planted(fault))
    torch.manual_seed(0)
    with plant():
        res = _run(name)
    assert res["checks"] and not res["correct"], res["checks"]
