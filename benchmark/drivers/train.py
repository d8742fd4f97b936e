"""The program's training step, issued back to back as the training CLI
issues it: no host synchronise per step.

Traffic parameters: `batch` (which of the configuration's batch sizes),
`n_past`, `n_future`, `dtype`, `remat`, `ft`, `weights` (a law of
`benchmark.weights`), `warmup_steps`, `trace_units` (steps the traced run
profiles). The steps cycle through DATA_POOL distinct clip batches made on
the card; cuDNN's autotuner is on, as the training CLI turns it on.

Set-up builds one train state and drives it through its first steps on
the first batches of the pool, by the same call the window makes: the
reference follows the first three of them from the same weights. At the
window's start set-up snapshots the state (parameters, BatchNorm
statistics, Adam's moments and update counts), and the reference follows
the window's first three steps from that snapshot: the program's own
state, which the reference cannot work out again without following every
step before it. With no warm-up steps (the mix's `warmup_steps` 0) the
snapshot is the state after the first three, which the first check holds.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark import data, weights
from benchmark.reference import nets
from benchmark.reference import train as ref_train
from benchmark.yardstick.flops import counted_flops

CHECK_STEPS = 3
DATA_POOL = 32
# leaves whose first gradient is under this share of the median leaf's are
# moved by Adam's round-off alone, and are not compared
GRAD_FLOOR = 1e-3


class Followed:
    """What the program did over the CHECK_STEPS steps from step `start`:
    each step's loss, Adam's first moments after the first, and the state
    after the last; `init` is the state the reference starts from."""

    def __init__(self, start: int, init: Dict):
        self.start, self.init = start, init
        self.losses: List = []
        self.m1 = self.state = None

    def record(self, drv: "Driver") -> None:
        k = drv.steps - self.start
        if not 0 <= k < CHECK_STEPS:
            return
        self.losses.append(drv.metrics["loss"])
        if k == 0:
            self.m1 = drv.moments("exp_avg")
        if k == CHECK_STEPS - 1:
            self.state = drv.model_state()

    def to_host(self) -> None:
        self.losses = [float(v) for v in self.losses]
        self.m1 = _cpu(self.m1)
        self.state = _cpu(self.state)
        adam = self.init["adam"]
        self.init = {"state": _cpu(self.init["state"]),
                     "adam": adam and dict(adam, m=_cpu(adam["m"]),
                                           v=_cpu(adam["v"]))}


class Driver:
    groups = "train"
    # window steps the check follows: a run or a reading makes this many
    # at least
    CHECK_UNITS = CHECK_STEPS

    def __init__(self, cell, seed: int, device, count_flops: bool = False,
                 overrides: Dict = None):
        from dvg_tpu_torch.config import DVGConfig
        from dvg_tpu_torch.models.dvg import DVGModel
        from dvg_tpu_torch.train.step import make_train_step, train_state
        conf, tr = cell.config, dict(cell.traffic)
        tr.update(overrides or {})
        self.tr, self.device = tr, torch.device(device)
        spec = dict(conf["model"])
        spec.update((overrides or {}).get("model", {}))
        self.b = tr.get("batch_size") or conf["batch"][tr["batch"]]
        cfg = DVGConfig.from_dict({
            **spec, "dtype": tr["dtype"], "remat": tr["remat"],
            "ft": tr["ft"], "batch_size": self.b, "n_past": tr["n_past"],
            "n_future": tr["n_future"]})
        self.cfg = cfg
        torch.backends.cudnn.benchmark = True
        self.weights = weights.make(spec, tr["weights"], seed, self.device)
        self.x = data.clips(conf["inputs"], spec, seed, DATA_POOL,
                            cfg.n_past + cfg.n_future, self.b, self.device)
        model = DVGModel(cfg, seed=0, device=self.device)
        model.load_state_dict(self.weights)
        self.state = train_state(model, cfg)
        self.step_fn = make_train_step(cfg)
        self.steps = 0
        self.finite: List[torch.Tensor] = []
        self.flops = None
        self._refs: Dict[int, Dict] = {}
        self.followed = [Followed(0, {"state": self.weights, "adam": None})]
        for k in range(CHECK_STEPS):
            if k == 0 and count_flops:
                self.flops = counted_flops(self.unit)
            else:
                self.unit()
        for _ in range(tr["warmup_steps"]):
            self.unit()
        self.window_from = self.steps
        self.followed.append(Followed(self.steps, {
            "state": self.model_state(),
            "adam": {"m": self.moments("exp_avg"),
                     "v": self.moments("exp_avg_sq"),
                     "t": dict(self.state.opts.counts)}}))
        self.sync()

    def moments(self, key: str) -> Dict[str, torch.Tensor]:
        opts = self.state.opts
        return {n: opts.adam[g].state[p][key].detach().clone()
                for g in opts.names
                for n, p in zip(opts.names[g], opts.params(g))}

    def model_state(self) -> Dict[str, torch.Tensor]:
        """Parameters and BatchNorm statistics, cloned."""
        return {k: v.detach().clone()
                for k, v in self.state.model.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self) -> None:
        x = self.x[self.steps % self.x.shape[0]]
        _, self.metrics = self.step_fn(self.state, x)
        self.finite.append(torch.isfinite(self.metrics["loss"]))
        for f in self.followed:
            f.record(self)
        self.steps += 1

    def trace_unit(self) -> None:
        from torch.profiler import record_function
        with record_function("bench.step"):
            self.unit()

    def measure(self, start: float, end: float) -> Dict[str, float]:
        return {"train_clips_per_s":
                (self.steps - self.window_from) * self.b / (end - start)}

    def failures(self, units: int) -> int:
        """The window's steps whose loss is not finite."""
        window = self.finite[self.window_from:self.window_from + units]
        return sum(not bool(f) for f in window)

    def trace_context(self) -> Dict:
        return {"units": "steps", "flops_per_unit": self.flops}

    def release(self) -> None:
        for f in self.followed:
            f.to_host()
        self.state = self.step_fn = self.metrics = None
        self.finite = [bool(f) for f in self.finite]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    def hyper(self) -> Dict:
        c = self.cfg
        return {"lr": c.lr, "beta1": c.beta1, "gp_lr": c.gp_lr,
                "gp_lr_milestones": tuple(c.gp_lr_milestones),
                "gp_lr_gamma": c.gp_lr_gamma, "epoch_size": c.epoch_size,
                "n_past": c.n_past, "ft": c.ft}

    def reference(self, f: Followed, ops: nets.Ops = None) -> Dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        batches = [self.x[(f.start + k) % DATA_POOL]
                   for k in range(CHECK_STEPS)]
        init = {k: v.to(self.device) for k, v in f.init["state"].items()}
        adam = f.init["adam"] and dict(
            f.init["adam"],
            m={k: v.to(self.device) for k, v in f.init["adam"]["m"].items()},
            v={k: v.to(self.device) for k, v in f.init["adam"]["v"].items()})
        return ref_train.train_steps(init, batches, self.hyper(), ops, adam)

    def readings(self, ops: nets.Ops = None) -> Dict[str, float]:
        """The compared numbers, worst over the followed steps (set-up's
        first and the window's first); with `ops` the reference so
        computed stands in for the program."""
        got: Dict[str, float] = {}
        for f in self.followed:
            if f.start not in self._refs:
                self._refs[f.start] = self.reference(f)
            prog = (self.reference(f, ops) if ops is not None else
                    {"losses": f.losses, "m1": f.m1, "state": f.state})
            adam = f.init["adam"]
            r = step_gaps(prog, self._refs[f.start], f.init["state"],
                          adam and adam["m"])
            for k, v in r.items():
                got[k] = max(got.get(k, 0.0), v)
        return got


def _cpu(tensors):
    return None if tensors is None else {k: v.cpu()
                                         for k, v in tensors.items()}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float().cpu()))
            for k, v in tensors.items()}


def _less_bias(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`state` on the host in f32, each BatchNorm's running mean less the
    bias of the conv before it."""
    out = {k: v.float().cpu() for k, v in state.items()}
    for k in out:
        bias = k[:-len("bn.running_mean")] + "conv.bias"
        if k.endswith(".bn.running_mean") and bias in out:
            out[k] = out[k] - out[bias]
    return out


def step_gaps(got: Dict, ref: Dict, init: Dict[str, torch.Tensor],
              m0: Dict[str, torch.Tensor] = None) -> Dict[str, float]:
    """Three steps' numbers against the reference's, both from the state
    `init` and Adam's first moments `m0` (None: fresh):
      * loss_gap: the worst relative |Δ| of a step's joint loss;
      * grad_gap: by the worst leaf, the gap between the norms of the first
        step's gradient as the optimizer took it (Adam's first moment
        after it, less the part it kept of m0), over the larger of the
        reference's norm of that leaf and of the median leaf;
      * grad_median: the same gap of the median leaf, steady from seed to
        seed where the worst leaf is a different one on each;
      * change_gap: the same of each leaf's change over the steps, the
        BatchNorm statistics among the leaves.
    Parameters whose reference gradient is under GRAD_FLOOR of the median
    leaf's are left out of both: the biases of the convs before a
    train-mode BatchNorm, which Adam moves by round-off alone. The batch
    mean carries such a bias whole, so a running mean is compared less
    it."""
    loss = max(abs(g - r) / abs(r) for g, r in zip(got["losses"],
                                                    ref["losses"]))

    def grads(m1):
        if m0 is None:
            return m1
        return {k: m1[k].float().cpu() - ref["decay"][k] * m0[k].float().cpu()
                for k in m1}
    g_ref, g_got = _norms(grads(ref["m1"])), _norms(grads(got["m1"]))
    med = float(torch.tensor(list(g_ref.values())).median())
    keep = [k for k in g_ref if g_ref[k] >= GRAD_FLOOR * med]
    by_leaf = torch.tensor([abs(g_got[k] - g_ref[k]) / max(g_ref[k], med)
                            for k in keep])
    leaves = keep + [k for k in ref["state"] if k not in g_ref]
    init, s_ref, s_got = (_less_bias(s) for s in (init, ref["state"],
                                                    got["state"]))
    d_ref = _norms({k: s_ref[k] - init[k] for k in leaves})
    d_got = _norms({k: s_got[k] - init[k] for k in leaves})
    dmed = float(torch.tensor(list(d_ref.values())).median())
    change = max(abs(d_got[k] - d_ref[k]) / max(d_ref[k], dmed)
                 for k in leaves)
    return {"loss_gap": loss, "grad_gap": float(by_leaf.max()),
            "grad_median": float(by_leaf.median()), "change_gap": change,
            "leaves_compared": float(len(leaves)),
            "leaves_left_out": float(len(g_ref) - len(keep))}
