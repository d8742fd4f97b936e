"""The port's soak CLI (`dvg_tpu_torch.cli.soak`), JAX-free:

  * its summary code, run on the JAX package's committed soak
    (runs/soak_smmnist/), gives the numbers that run logged: best-of-100
    equal to the eval CLI's ssim_best_mean, and the manifest's mean SSIM
    and epoch values exactly, so the two soaks are summarized alike;
  * the manifest's batch<i>_best_of_100_ssim of that run is another
    quantity (scripts/soak.py read the (B, S, T') arrays as (S, T', B));
  * experiments/tpu_precision.py's `score` prints a run's epoch plots'
    SSIM by frame and its eval's SSIM by free step beside the blank-frame
    and copy-last-frame baselines of its clips, its ink profile gives the
    TPU's plots' dimmed futures, its `--emulate` picks an emulation, and
    its `tpu_dots()` rounds the operands of f32 contractions to bf16;
  * the soak end to end on the CPU at a tiny geometry;
  * without --device cpu and with no card it raises before any work.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dvg_tpu_torch.cli import soak

TPU_RUN = os.path.join(soak.REPO, "runs", "soak_smmnist")
EXPERIMENT = os.path.join(soak.REPO, "experiments", "tpu_precision.py")


def tpu_precision():
    spec = importlib.util.spec_from_file_location("tpu_precision", EXPERIMENT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def tpu():
    with open(os.path.join(TPU_RUN, "manifest.json")) as f:
        manifest = json.load(f)
    evals = [r for r in _jsonl(os.path.join(TPU_RUN, "eval", "metrics.jsonl"))
             if r["kind"] == "eval"]
    return manifest, evals, soak.summarize(TPU_RUN, 100, 2)


@pytest.mark.parametrize("bi", [0, 1])
def test_best_of_100_is_the_eval_clis(tpu, bi):
    """best-of-100 = the eval CLI's ssim_best_mean (0.548710 / 0.542671)."""
    _, evals, summary = tpu
    assert evals[bi]["step"] == bi
    assert abs(summary[f"batch{bi}_best_of_100_ssim"]
               - evals[bi]["ssim_best_mean"]) <= 1e-6


def test_manifest_values_reproduced_exactly(tpu):
    manifest, _, summary = tpu
    for k in ("batch0_mean_ssim", "batch1_mean_ssim", "first_epoch_mse",
              "last_epoch_mse", "sustained_step_s"):
        assert summary[k] == manifest["summary"][k], k
    assert summary["trigger_count"] == 114
    assert "k1_launches_per_batch" not in summary   # dvg_tpu logs none


@pytest.mark.parametrize("bi", [0, 1])
def test_tpu_manifest_best_of_key_holds_another_quantity(tpu, bi):
    """The TPU manifest's best-of-100 is the mean over the samples, best of
    the 50 clips, averaged: scripts/soak.py's axes on the (B, S, T')
    arrays. It is not the best of the 100 futures."""
    manifest, _, summary = tpu
    with np.load(os.path.join(TPU_RUN, "eval", f"eval_batch{bi}.npz")) as z:
        ssim = z["ssim"]
    assert ssim.shape == (50, 100, 100)
    key = f"batch{bi}_best_of_100_ssim"
    assert manifest["summary"][key] == float(
        ssim.mean(axis=1).max(axis=0).mean())
    assert manifest["summary"][key] - summary[key] > 0.05


def test_compare_prints_curves_and_baselines():
    """The TPU's soak through `score`: its epoch-0 plot's first free frames
    and its eval curve beside the baselines of the same clips."""
    out = tpu_precision().score([TPU_RUN])
    assert ("sample_0.png SSIM by frame (free from 5, a fork at 10): best "
            "of 5 0.518 0.602 0.512") in out
    assert "t0 0.491 (0.684 / 0.784)" in out         # step 0 and baselines
    assert "mean over steps 0.5088 (blank 0.6909, copy-last 0.5539)" in out


@pytest.mark.parametrize("epoch,first,free", [(0, 0.476, 0.442),
                                               (10, 0.612, 0.730),
                                               (40, 0.652, 0.636)])
def test_ink_profile_of_the_tpus_plots(epoch, first, free):
    """The TPU's epoch plots dim their futures: mean predicted over mean
    ground-truth intensity, all 5 samples of the 10 clips, at the first
    free frame and over the free frames (5-14); the context frames are
    the ground truth's own."""
    t = tpu_precision()
    tiles = t.plot_tiles(os.path.join(TPU_RUN, "model",
                                      f"sample_{epoch}.png"))
    ink = t.ink_profile(tiles)
    np.testing.assert_allclose(ink[:5], 1.0, rtol=1e-6)
    assert round(float(ink[5]), 3) == first
    assert round(float(tiles[:, 1:, 5:].mean() / tiles[:, 0, 5:].mean()),
                 3) == free


@pytest.mark.parametrize("argv,want", [
    (["--emulate", "bias", "m", "--x"], ("bias", ["m", "--x"])),
    (["--emulate", "dots", "m"], ("dots", ["m"])),
    (["m", "--x"], ("dots", ["m", "--x"]))])
def test_emulate_flag_selects_the_emulation(argv, want):
    assert tpu_precision()._emulation(argv) == want


def test_emulate_flag_refuses_others():
    with pytest.raises(SystemExit, match="--emulate"):
        tpu_precision()._emulation(["--emulate", "tpu", "m"])


def test_tpu_dots_rounds_f32_operands():
    """tpu_dots() (in a process of its own: it patches torch) makes an f32
    einsum, bmm, matmul and @ equal the product of bf16-rounded operands
    accumulated in f32, and leaves f64 alone."""
    code = f"""
import importlib.util, torch
spec = importlib.util.spec_from_file_location("t", {EXPERIMENT!r})
t = importlib.util.module_from_spec(spec); spec.loader.exec_module(t)
g = torch.Generator().manual_seed(0)
a, b = (torch.randn(3, 16, 16, generator=g) for _ in range(2))
want = a.bfloat16().double() @ b.bfloat16().double()
exact = a.double() @ b.double()
t.tpu_dots()
for got in (torch.einsum("bij,bjk->bik", a, b), torch.bmm(a, b),
            torch.matmul(a, b), a @ b):
    assert (got.double() - want).abs().max() < 1e-5
    assert (got.double() - exact).abs().max() > 1e-3
assert torch.equal(a.double() @ b.double(), exact)
"""
    subprocess.run([sys.executable, "-c", code], check=True)


def test_soak_end_to_end_on_cpu(tmp_path, monkeypatch):
    """The three CLIs as subprocesses at a tiny geometry: the manifest's
    keys, a finite summary, the device naming the CPU, the logs kept and
    the renders and the (over 64 MB) checkpoint dropped but the epoch plot
    (model/sample_0.png), as scripts/soak.py keeps it. One intra-op
    thread per subprocess: the suite runs several workers at once."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "soak"
    assert soak.main(["--device", "cpu", "--out", str(out), "--tiny"]) == 0
    manifest = json.loads((out / "manifest.json").read_text())
    assert set(manifest) == {"protocol", "train_flags", "eval_flags",
                             "dataset_note", "git_rev", "device", "wall_s",
                             "summary"}
    assert manifest["device"].startswith("cpu")
    assert set(manifest["wall_s"]) == {"train", "eval", "trigger"}
    summary = manifest["summary"]
    assert set(summary) == {"batch0_best_of_2_ssim", "batch0_mean_ssim",
                            "first_epoch_mse", "last_epoch_mse",
                            "sustained_step_s", "trigger_count",
                            "k1_launches_per_batch"}
    assert summary["k1_launches_per_batch"] == [0]    # plain on the CPU
    for k, v in summary.items():
        if k != "k1_launches_per_batch":
            assert math.isfinite(v), k
    assert summary["batch0_best_of_2_ssim"] >= summary["batch0_mean_ssim"]
    epochs = [r for r in _jsonl(out / "train" / "metrics.jsonl")
              if r["kind"] == "epoch"]
    assert [r["step"] for r in epochs] == [0, 1]
    for log in ("train", "eval", "trigger"):
        assert (out / f"{log}_stdout.log").stat().st_size > 0
    with np.load(out / "eval" / "eval_batch0.npz") as z:
        assert z["ssim"].shape == (2, 2, 10)
    left = [str(p.relative_to(out)) for p in out.rglob("*")
            if p.suffix in (".gif", ".png")]
    assert left == [os.path.join("model", "sample_0.png")]
    assert not (out / "recursive_generation").exists()
    assert not (out / "model" / "model.ckpt").exists()


def test_soak_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        soak.main(["--out", str(tmp_path / "soak"), "--quick"])
    assert not (tmp_path / "soak").exists()
