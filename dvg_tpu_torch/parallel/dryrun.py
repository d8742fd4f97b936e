"""A multi-process dry run of the port's parallel paths on the CPU, the
port-side analogue of `__graft_entry__.dryrun_multichip`:

    python -c "from dvg_tpu_torch.parallel.dryrun import dryrun_multiproc; \\
               dryrun_multiproc(4)"

`dryrun_multiproc(n)` spawns n processes joined over gloo (the DVG_* env
contract on a free localhost port), and on `__graft_entry__._tiny_cfg`'s
widths runs

  1. one data-parallel train step in f64 (`make_train_step(cfg, group)`),
     each rank on its B/n rows of one global batch;
  2. the sharded diverse eval (`shard_diverse_metrics`) on a mesh of
     ("sample", n) — ("sample", n/2) × ("data", 2) when n ≥ 4 is even —
     with the seeded noise and, when given, with explicit eps. The eval's
     clip is cut to n_past 14, n_eval 16, so that its second free step is
     a fork step (step 15) and the sample ids matter at a cheap depth;
  3. `broadcast_state` of rank 0's post-step TrainState onto every rank's
     fresh one (no Adam state yet), as a resumed run takes rank 0's;
  4. `read_checkpoint_bytes_synced` of a checkpoint that only rank 0's
     path holds (every rank gets its bytes), and of a missing one (rank 0
     raises its error and every peer raises too, none waits);

then runs the same step without a group on rank 0 and the same eval in
this process, and asserts that the ranks agree with each other and with
those: metrics and
gradients within 1e-10 of their scale, weights, BN statistics and Adam
moments within 1e-10 — except the conv biases that feed a train-mode BN,
whose gradient is rounding noise that Adam's first update amplifies to
up to lr·(|g_a| + |g_b|)/eps (tests/test_torch_train.py), and the encoder
running means those biases shift — and the gathered eval metrics within
1e-6 (PSNR relative). Returns every rank's results and the references for the caller
(tests/test_torch_parallel.py holds them against `dvg_tpu`'s).

`serve_multiproc(path, n, x, seed)` runs a sharded serving artifact
(`serve/export.py`) on n gloo ranks the same way and returns what every
rank's call gave.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# __graft_entry__._tiny_cfg's fields
TINY = dict(dataset="smmnist", channels=1, image_width=64, batch_size=8,
            n_past=2, n_future=2, n_eval=6, g_dim=16, rnn_size=64,
            num_inducing_points=8, epoch_size=4, ft=True)
EVAL = dict(n_past=14, n_future=2, n_eval=16, batch_size=4,
            dtype="float32", use_pallas=True)
EVAL_S_LOCAL = 2           # futures per sample rank
EVAL_SEED = 7
TOL = 1e-10                # f64 step
EVAL_TOL = 1e-6            # f32 eval
ADAM_LR, ADAM_EPS = 0.002, 1e-8


def mesh_axes(n: int) -> List[tuple]:
    if n >= 4 and n % 2 == 0:
        return [("sample", n // 2), ("data", 2)]
    return [("sample", n)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cfgs(n: int):
    from dvg_tpu_torch.config import DVGConfig
    n_s = dict(mesh_axes(n))["sample"]
    train = DVGConfig(**TINY)
    evalc = train.replace(**EVAL, nsample=EVAL_S_LOCAL * n_s)
    return train, evalc


def default_inputs(n: int) -> Dict[str, Any]:
    """Seeded weights (the init law) and clips."""
    from dvg_tpu_torch.models.dvg import DVGModel
    train, evalc = _cfgs(n)
    rng = np.random.RandomState(1)
    w = train.image_width
    return {
        "state_dict": DVGModel(train, seed=0, device="cpu").state_dict(),
        "x": rng.rand(train.seq_len_train, train.batch_size, w, w,
                      train.channels),
        "eval_state_dict": DVGModel(evalc, seed=1, device="cpu").state_dict(),
        "x_eval": rng.rand(evalc.n_eval, evalc.batch_size, w, w,
                           evalc.channels).astype(np.float32),
        "noise": None}


def f64_state(cfg, state_dict, device="cpu"):
    """A fresh f64 TrainState holding `state_dict` on `device`."""
    from dvg_tpu_torch.models.dvg import DVGModel
    from dvg_tpu_torch.train import train_state
    model = DVGModel(cfg, device="cpu")
    model.load_state_dict(state_dict)
    return train_state(model.double().to(device), cfg)


def _moments(state) -> Dict[str, tuple]:
    opts = state.opts
    return {n: (opts.adam[g].state[p]["exp_avg"].clone(),
                opts.adam[g].state[p]["exp_avg_sq"].clone())
            for g in opts.adam for n, p in zip(opts.names[g],
                                               opts.params(g))}


def step_result(cfg, state_dict, x, group, device="cpu") -> Dict[str, Any]:
    """One f64 step from `state_dict` on x → metrics, state_dict, each
    parameter's last gradient (the joint pass's for the encoder and
    decoder, pass 2's for the LSTM, pass 3's for the GP group) and Adam
    moments, all on the CPU, and the state itself."""
    from dvg_tpu_torch.train import make_train_step
    state, metrics = make_train_step(cfg, group)(
        f64_state(cfg, state_dict, device), x)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state_dict": {k: v.cpu().clone()
                           for k, v in state.model.state_dict().items()},
            "grads": {n: p.grad.cpu().clone()
                      for n, p in state.model.named_parameters()},
            "moments": {k: tuple(t.cpu() for t in v)
                        for k, v in _moments(state).items()},
            "state": state}


def _eval_fns(cfg, state_dict, nsample: int):
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    from dvg_tpu_torch.models.dvg import DVGModel
    model = DVGModel(cfg, device="cpu")
    model.load_state_dict(state_dict)
    return make_rollout_fns(model, cfg.replace(nsample=nsample))


def _rank(rank: int, n: int, port: int, tmp: str) -> None:
    """One rank: join the group, run the step and the eval, save the
    results to tmp/rank<r>.pt (or the traceback to tmp/rank<r>.err)."""
    try:
        os.environ.update(DVG_COORDINATOR=f"localhost:{port}",
                          DVG_NUM_PROCESSES=str(n), DVG_PROCESS_ID=str(rank))
        torch.set_num_threads(1)
        import torch.distributed as dist
        from dvg_tpu_torch.parallel import (broadcast_state, distributed_init,
                                            make_mesh, shard_diverse_metrics)
        from dvg_tpu_torch.checkpoint import read_checkpoint_bytes_synced
        from dvg_tpu_torch.parallel.collectives import all_gather
        if not distributed_init(device="cpu"):
            raise RuntimeError("the DVG_* env did not start a group")
        inputs = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
        train, evalc = _cfgs(n)
        b = train.batch_size // n
        x = inputs["x"][:, rank * b:(rank + 1) * b]
        out = {"step": step_result(train, inputs["state_dict"], x,
                             dist.group.WORLD)}
        stepped = out["step"].pop("state")
        if rank == 0:
            # the one-process step on the whole batch, here, where a group
            # is up: a step without a group must not read the group's size
            out["ref_step"] = step_result(train, inputs["state_dict"],
                                          inputs["x"], None)
            del out["ref_step"]["state"]
        fresh = f64_state(train, inputs["state_dict"])
        if rank:
            fresh.model.encoder.head.conv.weight.data.add_(1.0)
        got = broadcast_state(stepped if rank == 0 else fresh)
        flat = torch.cat([t.reshape(-1).double() for t in
                          list(got.model.state_dict().values())
                          + [m for pair in _moments(got).values()
                             for m in pair]])
        out["broadcast_equal"] = (
            got.step == 1 and got.opts.counts == stepped.opts.counts
            and all(torch.equal(flat, f) for f in all_gather(flat)))
        mesh = make_mesh(mesh_axes(n))
        metrics = shard_diverse_metrics(
            _eval_fns(evalc, inputs["eval_state_dict"], EVAL_S_LOCAL), mesh)
        out["coordinate"] = list(mesh.get_coordinate())
        out["eval_seeded"] = metrics(inputs["x_eval"], seed=EVAL_SEED,
                                     device="cpu")
        if inputs["noise"] is not None:
            out["eval_noise"] = metrics(inputs["x_eval"],
                                        noise=inputs["noise"], device="cpu")
        # every rank ends the step with rank 0's weights and BN statistics
        flat = torch.cat([v.reshape(-1).double() for v in
                          out["step"]["state_dict"].values()])
        out["state_equal_on_ranks"] = all(
            torch.equal(flat, f) for f in all_gather(flat))
        out["ckpt_bytes"] = read_checkpoint_bytes_synced(
            str(Path(tmp) / f"ckpt{rank}"))
        try:
            read_checkpoint_bytes_synced(str(Path(tmp) / "missing.ckpt"))
            out["ckpt_missing"] = "read"
        except (OSError, RuntimeError) as e:
            out["ckpt_missing"] = type(e).__name__
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_ranks(target, n: int, args: tuple, timeout_s: float) -> None:
    """Spawn n processes `target(rank, n, *args)`; a rank that fails, or
    runs past `timeout_s`, stops the others and raises."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, n) + args, daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                raise RuntimeError(
                    f"ranks {failed} failed" if failed else
                    f"ranks still running after {timeout_s} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks {failed} failed")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def noise_bias(name: str) -> bool:
    """A conv bias feeding a train-mode BN: its gradient is rounding."""
    return name.endswith("conv.bias") and not name.startswith(
        "decoder.final")


def step_errors(got: Dict[str, Any], ref: Dict[str, Any],
                tol: float = TOL) -> Dict[str, float]:
    """The largest excess of `got`'s step over `ref`'s beyond the bounds in
    the module docstring (`tol` for 1e-10), by kind; ≤ 0 everywhere when
    they agree."""
    out = {"metrics": max(abs(got["metrics"][k] - v) - tol * max(abs(v), 1)
                          for k, v in ref["metrics"].items())}
    out["grads"] = max(
        float((got["grads"][k] - g).abs().max())
        - tol * max(float(g.abs().max()), 1.0)
        for k, g in ref["grads"].items())
    bias_d, worst = {}, -1.0
    for k, v in ref["state_dict"].items():
        if "num_batches" in k:
            continue
        d = (got["state_dict"][k] - v).abs()
        if noise_bias(k):
            bound = ADAM_LR * (float(got["grads"][k].abs().max())
                               + float(ref["grads"][k].abs().max())
                               ) / ADAM_EPS + tol
            if k.startswith("encoder"):
                bias_d[k.replace("conv.bias", "bn.running_mean")] = d
        elif k in bias_d:
            bound = bias_d[k] + tol
        else:
            bound = tol
        worst = max(worst, float((d - bound).max()))
    out["state"] = worst
    out["moments"] = max(float((got["moments"][k][i] - m[i]).abs().max())
                         - tol for k, m in ref["moments"].items()
                         for i in (0, 1))
    return out


def eval_error(got: Dict[str, torch.Tensor],
               ref: Dict[str, torch.Tensor]) -> float:
    """max |Δ| of SSIM and MSE and max |Δ|/|PSNR| (PSNR is ~10-40 dB, where
    one f32 ulp is 1-4e-6 dB)."""
    return max(float(((got[k] - ref[k]).abs()
                      / (ref[k].abs() if k == "psnr" else 1.0)).max())
               for k in ref)


def _serve_rank(rank: int, n: int, port: int, tmp: str) -> None:
    """One rank of `serve_multiproc`: join the group, load the sharded
    artifact and call it on the whole clip; saves the gathered metrics and
    the model or generation modules this process imported to
    tmp/serve<r>.pt (or the traceback to tmp/serve<r>.err)."""
    import sys
    try:
        os.environ.update(DVG_COORDINATOR=f"localhost:{port}",
                          DVG_NUM_PROCESSES=str(n), DVG_PROCESS_ID=str(rank))
        torch.set_num_threads(1)
        import torch.distributed as dist
        from dvg_tpu_torch.parallel import distributed_init
        from dvg_tpu_torch.serve import load_serving
        if not distributed_init(device="cpu"):
            raise RuntimeError("the DVG_* env did not start a group")
        inputs = torch.load(Path(tmp) / "serve_inputs.pt", weights_only=False)
        served = load_serving(inputs["path"])
        out = {"metrics": served(inputs["x"], inputs["seed"]),
               "modules": sorted(m for m in sys.modules if m.startswith(
                   ("dvg_tpu_torch.models", "dvg_tpu_torch.generate")))}
        torch.save(out, Path(tmp) / f"serve{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"serve{rank}.err").write_text(traceback.format_exc())
        raise


def serve_multiproc(path: str, n: int, x, seed: int,
                    timeout_s: float = 600.0) -> List[Dict[str, Any]]:
    """Run the sharded serving artifact `path` (`serve.export_serving(...,
    mesh_samples=...)`, exported for the CPU) on n gloo ranks, every rank
    calling it on the whole clip x with `seed` → each rank's {"metrics":
    gathered (S, n_free, B) metrics, "modules": the model or generation
    modules it imported}."""
    with tempfile.TemporaryDirectory(prefix="dvg_serve_") as tmp:
        torch.save({"path": str(path), "x": torch.as_tensor(x),
                    "seed": seed}, Path(tmp) / "serve_inputs.pt")
        try:
            run_ranks(_serve_rank, n, (free_port(), tmp), timeout_s)
        except RuntimeError as e:
            errs = "\n".join(p.read_text()
                             for p in sorted(Path(tmp).glob("*.err")))
            raise RuntimeError(f"{e}\n{errs}") from None
        return [torch.load(Path(tmp) / f"serve{r}.pt", weights_only=False)
                for r in range(n)]


def dryrun_multiproc(n: int, inputs: Optional[Dict[str, Any]] = None,
                     timeout_s: float = 600.0) -> Dict[str, Any]:
    """Run the module docstring's checks on n gloo ranks on the CPU →
    {"ranks": [each rank's results], "ref_step", "ref_eval_seeded",
    "ref_eval_noise", "step_errors", "eval_errors"}. `inputs` replaces
    `default_inputs(n)` (keys "state_dict", "x", "eval_state_dict",
    "x_eval", "noise": eps (n_free, S, B, g_dim) or None)."""
    if n < 2:
        raise ValueError(f"dryrun_multiproc needs 2 or more ranks, got {n}")
    inputs = inputs or default_inputs(n)
    train, evalc = _cfgs(n)
    from dvg_tpu_torch.checkpoint import save_checkpoint
    from dvg_tpu_torch.models.dvg import DVGModel
    with tempfile.TemporaryDirectory(prefix="dvg_dryrun_") as tmp:
        torch.save(inputs, Path(tmp) / "inputs.pt")
        ckpt = Path(save_checkpoint(str(Path(tmp) / "ckpt0"), train,
                                    DVGModel(train, device="cpu")))
        ckpt_bytes = ckpt.read_bytes()
        try:
            run_ranks(_rank, n, (free_port(), tmp), timeout_s)
        except RuntimeError as e:
            errs = "\n".join(p.read_text()
                             for p in sorted(Path(tmp).glob("*.err")))
            raise RuntimeError(f"{e}\n{errs}") from None
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(n)]
    ref_step = ranks[0].pop("ref_step")
    fns = _eval_fns(evalc, inputs["eval_state_dict"], evalc.nsample)
    out = {"ranks": ranks, "ref_step": ref_step,
           "ref_eval_seeded": fns.diverse_metrics(
               inputs["x_eval"], seed=EVAL_SEED, device="cpu"),
           "ref_eval_noise": None if inputs["noise"] is None else
           fns.diverse_metrics(inputs["x_eval"], noise=inputs["noise"],
                               device="cpu")}
    out["step_errors"] = step_errors(ranks[0]["step"], ref_step)
    out["eval_errors"] = [eval_error(r[f"eval_{kind}"], out[f"ref_eval_{kind}"])
                          for r in ranks for kind in ("seeded", "noise")
                          if out[f"ref_eval_{kind}"] is not None]
    if any(r["ckpt_bytes"] != ckpt_bytes for r in ranks):
        raise AssertionError("a rank read other bytes than rank 0's file")
    missing = [r["ckpt_missing"] for r in ranks]
    if missing != ["FileNotFoundError"] + ["RuntimeError"] * (n - 1):
        raise AssertionError(f"a failed read on rank 0 raised {missing}")
    if max(out["step_errors"].values()) > 0:
        raise AssertionError(f"the {n}-rank step differs from the "
                             f"one-process step: {out['step_errors']}")
    if not all(r["state_equal_on_ranks"] for r in ranks):
        raise AssertionError("the ranks' post-step states differ")
    if not all(r["broadcast_equal"] for r in ranks):
        raise AssertionError("broadcast_state left a rank's state unlike "
                             "rank 0's")
    if max(out["eval_errors"]) > EVAL_TOL:
        raise AssertionError(f"the sharded eval differs from the one-process "
                             f"eval: {out['eval_errors']}")
    print(f"dryrun_multiproc({n}): step excess over bounds "
          f"{out['step_errors']}; eval max |d| {max(out['eval_errors']):.3e} "
          f"on mesh {mesh_axes(n)}")
    return out
