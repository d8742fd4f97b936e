"""The program's diverse eval protocol (`diverse_metrics`), one caller in
a closed loop.

Traffic parameters: `route` (k1 | stock | finn: the metric), `nsample`
(S), `n_eval`, `batch` (which of the configuration's batch sizes), `dtype`,
`full_cov`, `weights` (a law of `benchmark.weights`), `warmup_calls`,
`trace_units` (calls the traced run profiles).

Each call gets the next of INPUT_POOL clip batches and its own GP seed,
and the caller waits for its outputs (a synchronise) before the next call.
cuDNN's autotuner is on: a cell's shapes are fixed.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import data, weights
from benchmark.reference import nets
from benchmark.reference import rollout as ref_rollout
from benchmark.yardstick.flops import counted_flops


def _program():
    from dvg_tpu_torch.config import DVGConfig
    from dvg_tpu_torch.generate.rollout import make_rollout_fns
    from dvg_tpu_torch.models.dvg import DVGModel
    from dvg_tpu_torch.ops.ssim_cuda import (ssim_psnr_batch_cyclic,
                                             ssim_psnr_batch_images)
    return (DVGConfig, make_rollout_fns, DVGModel, ssim_psnr_batch_cyclic,
            ssim_psnr_batch_images)


INPUT_POOL = 4           # distinct clip batches, cycled
CHECK_SAMPLES = 10       # futures the reference re-rolls per checked call
REF_BLOCK = 5            # futures it rolls at once


class Driver:
    groups = "eval"
    # calls of the window that are never fewer than this; the checked call
    # is drawn among them
    FIRST_CALLS = 4
    # window calls a reading makes at least
    CHECK_UNITS = 1

    def __init__(self, cell, seed: int, device, count_flops: bool = False,
                 overrides: Dict = None):
        (DVGConfig, make_rollout_fns, DVGModel, self._k1,
         self._k2) = _program()
        conf, tr = cell.config, dict(cell.traffic)
        tr.update(overrides or {})
        self.tr, self.seed, self.device = tr, seed, torch.device(device)
        self.spec = dict(conf["model"])
        self.spec.update((overrides or {}).get("model", {}))
        self.b = tr.get("batch_size") or conf["batch"][tr["batch"]]
        self.n_eval, self.s_n = tr["n_eval"], tr["nsample"]
        self.n_past = self.spec["n_past"]
        self.n_free = self.n_eval - self.n_past
        cfg = DVGConfig.from_dict({
            **self.spec, "dtype": tr["dtype"],
            "use_pallas": tr["route"] == "k1",
            "eval_metric": "finn" if tr["route"] == "finn" else "skimage",
            "nsample": self.s_n, "n_eval": self.n_eval,
            "n_future": self.n_eval - self.n_past, "batch_size": self.b,
            "full_cov_sampling": tr["full_cov"]})
        torch.backends.cudnn.benchmark = True
        self.weights = weights.make(self.spec, tr["weights"], seed,
                                    self.device)
        self.x = data.clips(conf["inputs"], self.spec, seed, INPUT_POOL,
                            self.n_eval, self.b, self.device)
        model = DVGModel(cfg, seed=0, device=self.device)
        model.load_state_dict(self.weights)
        self.model = model
        fns = make_rollout_fns(model, cfg)
        self.entry = fns.diverse_metrics
        self.calls = 0
        self.times: List[float] = []
        self.launches: List[tuple] = []
        self.finite: List[torch.Tensor] = []
        # outputs of the checked call and of the last, by call index
        self.kept: Dict[int, Dict] = {}
        self.checked = random.Random(seed).randrange(1, self.FIRST_CALLS)
        self.flops = None
        self._refs: Dict[int, Dict] = {}
        for i in range(tr["warmup_calls"]):
            if i == 0 and count_flops:
                self.flops = counted_flops(lambda: self._call(-1))
            else:
                self._call(-1 - i)
            self.sync()

    # -- the program's calls -------------------------------------------------
    def call_seed(self, i: int) -> int:
        return self.seed * 4096 + i

    def batch(self, i: int) -> torch.Tensor:
        return self.x[i % self.x.shape[0]]

    def _call(self, i: int):
        return self.entry(self.batch(i), seed=self.call_seed(i),
                          device=self.device.type)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self) -> None:
        i = self.calls
        k1, k2 = self._k1.launches, self._k2.launches
        t0 = time.perf_counter()
        out = self._call(i)
        self.sync()
        self.times.append(time.perf_counter() - t0)
        self.launches.append((self._k1.launches - k1,
                              self._k2.launches - k2))
        self.finite.append(torch.stack([torch.isfinite(t.float()).all()
                                        for t in out.values()]).all())
        self.kept = {k: v for k, v in self.kept.items() if k == self.checked}
        self.kept[i] = out
        self.last = i
        self.calls += 1

    def trace_unit(self) -> None:
        from torch.profiler import record_function
        i = self.calls
        with record_function("bench.call"):
            self._call(i)
        with record_function("bench.sync"):
            self.sync()
        self.calls += 1

    def measure(self, start: float, end: float) -> Dict[str, float]:
        frames = len(self.times) * self.s_n * self.n_free * self.b
        return {"eval_frames_per_s": frames / (end - start)}

    def failures(self, units: int) -> int:
        """The window's calls whose outputs are not all finite, or that
        launched K1 other than once a free step (K2: never)."""
        k1_want = self.n_free if self.tr["route"] == "k1" else 0
        # launches are counted by the card's kernels only
        counted = self.device.type == "cuda"
        return sum(not bool(ok) or (counted and (k1 != k1_want or k2 != 0))
                   for ok, (k1, k2) in zip(self.finite[:units],
                                           self.launches[:units]))

    def trace_context(self) -> Dict:
        h = w = self.spec["image_width"]
        return {"units": "calls", "flops_per_unit": self.flops,
                "k1_shape": (self.s_n, self.b, h, w, self.spec["channels"],
                             2 if self.tr["dtype"] == "bfloat16" else 4)}

    def release(self) -> None:
        """Free the program's state; keep what the benchmark made and the
        kept outputs, moved to the host."""
        self.entry = self.model = None
        self.kept = {i: {k: v.cpu() for k, v in out.items()}
                     for i, out in self.kept.items()}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    def checked_calls(self) -> List[tuple]:
        """(call index, program output) of the calls the reference follows:
        one drawn from the seed among the first calls, and the last."""
        return sorted(self.kept.items())

    def readings(self, ops: nets.Ops = None, calls: List[tuple] = None
                 ) -> Dict[str, float]:
        """The compared numbers, worst over the checked calls; with `ops`
        the reference so computed stands in for the program."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        got: Dict[str, float] = {}
        for i, prog in calls or self.checked_calls():
            for k, v in self._read_metrics(i, prog, ops).items():
                got[k] = max(got.get(k, 0.0), v)
        return got

    def sample_ids(self, i: int) -> List[int]:
        rng = random.Random(self.call_seed(i))
        return sorted(rng.sample(range(self.s_n),
                                 min(CHECK_SAMPLES, self.s_n)))

    def _read_metrics(self, i, prog, ops) -> Dict[str, float]:
        sids = self.sample_ids(i)

        def reference(o):
            return ref_rollout.diverse_scores(
                self.weights, self.batch(i), self.n_past, self.n_eval,
                self.call_seed(i), sids, o, block=REF_BLOCK)
        ref = self._cached(i, lambda: reference(None))
        # the control: the fp8 reference in the program's place
        got = reference(ops) if ops is not None else {
            k: prog[k][sids] for k in ("ssim", "psnr", "mse")}
        return metric_gaps(got, ref, self.fork_step())

    def _cached(self, i: int, fn):
        """The f32 reference of call i, worked out once."""
        if i not in self._refs:
            self._refs[i] = fn()
        return self._refs[i]

    def fork_step(self) -> int:
        forks = np.nonzero(np.arange(self.n_past, self.n_eval)
                           % ref_rollout.FORK_EVERY == 0)[0]
        return int(forks[0]) if len(forks) else self.n_free


def metric_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                fork: int) -> Dict[str, float]:
    """Gaps of (K, n_free, B) ssim/psnr/mse against the reference's:
      * ssim_prefork: the worst |Δssim| over the free steps before the
        first GP fork (`fork`): encoder, LSTM, decoder and metric;
      * ssim_at_fork: the worst |Δssim| at the first fork step, whose
        latent is the GP's sample;
      * psnr_prefork: the worst |Δpsnr| (dB) before the fork;
      * ssim_mean: over all steps, the largest |Δ| of a step's mean SSIM
        over (future, row). Later steps separate no precision from another:
        the rollout feeds its own rounding back."""
    got = {k: v.float().cpu() for k, v in got.items()}
    ref = {k: v.float().cpu() for k, v in ref.items()}
    ds = (got["ssim"] - ref["ssim"]).abs()                 # (K, n_free, B)
    dq = (got["psnr"] - ref["psnr"]).abs()
    mean_gap = (got["ssim"].mean((0, 2)) - ref["ssim"].mean((0, 2))).abs()
    fork = min(max(fork, 1), ds.shape[1] - 1)
    return {"ssim_prefork": float(ds[:, :fork].max()),
            "ssim_at_fork": float(ds[:, fork].max()),
            "psnr_prefork": float(dq[:, :fork].max()),
            "ssim_mean": float(mean_gap.max())}
