"""Optimizers of the port's train step (counterpart of
`dvg_tpu/train/optim.py`): four `torch.optim.Adam` groups over the model's
modules and the GP group's MultiStepLR schedule, with their state carried
to and from `dvg_tpu`'s optax layout for checkpoints.

  * frame_predictor, encoder, decoder: Adam(lr, betas=(beta1, 0.999),
    eps=1e-8), one update per batch;
  * gp_group (gp + likelihood): Adam with b1 0.9 whatever --beta1 says,
    whose learning rate is set before each of its updates to
    `gp_lr_schedule(count // updates_per_batch)`, `count` being the GP
    group's own updates so far: two per batch with the finetune passes on
    (optax's scale_by_schedule count).

Adam's update is elementwise, so its moments follow the parameters through
the same layout maps as the weights (`convert.py`). In a `dvg_tpu`
checkpoint each group's state is `[{count, mu, nu}, {}]` (optax.adam's
chain of scale_by_adam and the learning-rate scale) and the GP group's
`[{count, mu, nu}, {count}]` (its schedule's count).
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.convert import params_from_jax, params_to_jax
from dvg_tpu_torch.utils.profiling import span

MODULE_GROUPS = ("frame_predictor", "encoder", "decoder", "gp_group")
# optimizer group → the DVGModel children it steps
GROUP_MODULES = {"frame_predictor": ("frame_predictor",),
                 "encoder": ("encoder",), "decoder": ("decoder",),
                 "gp_group": ("gp", "likelihood")}
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
GP_B1 = 0.9


def gp_lr_schedule(cfg: DVGConfig) -> Callable[[int], float]:
    """The GP learning rate at a (batch) step: torch's MultiStepLR stepped
    before each epoch, so a milestone m decays the rate during the epochs e
    with e + 1 >= m. The rate is rounded as `dvg_tpu` computes it, in f32
    (base · γ · γ …), so both packages step by the same value. `.at_epoch`
    gives the unrounded rate of an epoch."""
    milestones = tuple(cfg.gp_lr_milestones)
    gamma, base = np.float32(cfg.gp_lr_gamma), np.float32(cfg.gp_lr)

    def schedule(step: int) -> float:
        epoch = step // cfg.epoch_size
        factor = np.float32(1.0)
        for m in milestones:
            if epoch + 1 >= m:
                factor = np.float32(factor * gamma)
        return float(np.float32(base * factor))

    schedule.at_epoch = lambda e: cfg.gp_lr * (
        cfg.gp_lr_gamma ** bisect_right(list(milestones), e + 1))
    return schedule


def split_params(model: nn.Module) -> Dict[str, List[Tuple[str, nn.Parameter]]]:
    """The model's parameters by optimizer group, each as (state_dict name,
    parameter) pairs."""
    return {g: [(f"{child}.{n}", p) for child in children
                for n, p in getattr(model, child).named_parameters()]
            for g, children in GROUP_MODULES.items()}


class Optimizers:
    """The four Adam groups of one model, and each group's update count
    (optax's `count`), kept on the host so that reading it never waits for
    the card."""

    def __init__(self, cfg: DVGConfig, model: nn.Module):
        self.names: Dict[str, List[str]] = {}
        self.adam: Dict[str, torch.optim.Adam] = {}
        for g, pairs in split_params(model).items():
            b1 = GP_B1 if g == "gp_group" else cfg.beta1
            lr = cfg.gp_lr if g == "gp_group" else cfg.lr
            self.names[g] = [n for n, _ in pairs]
            self.adam[g] = torch.optim.Adam([p for _, p in pairs], lr=lr,
                                            betas=(b1, ADAM_B2), eps=ADAM_EPS)
        self.counts = {g: 0 for g in MODULE_GROUPS}
        self.schedule = gp_lr_schedule(cfg)
        self.updates_per_batch = 2 if cfg.ft else 1

    def params(self, group: str) -> List[torch.Tensor]:
        return self.adam[group].param_groups[0]["params"]

    def zero_grad(self, *groups: str) -> None:
        for g in groups or MODULE_GROUPS:
            self.adam[g].zero_grad(set_to_none=True)

    @span("dvg.train.optim")
    def step(self, group: str) -> None:
        """One Adam update of `group`. A parameter the pass did not reach
        takes a zero gradient, as in optax, so its moments still decay."""
        for p in self.params(group):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if group == "gp_group":
            self.adam[group].param_groups[0]["lr"] = self.schedule(
                self.counts[group] // self.updates_per_batch)
        self.adam[group].step()
        self.counts[group] += 1

    def state_tensors(self) -> List[torch.Tensor]:
        """Every Adam step count and moment, in a fixed order, for a
        broadcast from another rank (`parallel.broadcast_state`): a group
        that has taken updates gets zero entries where it has none (a rank
        that did not load the state), one that has not gets none."""
        out = []
        for g in MODULE_GROUPS:
            opt = self.adam[g]
            if self.counts[g] == 0:
                opt.state.clear()
                continue
            for p in self.params(g):
                st = opt.state[p]
                if not st:
                    st.update(step=torch.tensor(float(self.counts[g]),
                                                dtype=torch.float32),
                              exp_avg=torch.zeros_like(p),
                              exp_avg_sq=torch.zeros_like(p))
                out += [st["step"], st["exp_avg"], st["exp_avg_sq"]]
        return out

    # -- dvg_tpu's optax layout ----------------------------------------------
    def _moments(self, model: nn.Module, key: str) -> Dict[str, torch.Tensor]:
        sd = dict(model.state_dict())
        for g, opt in self.adam.items():
            for name, p in zip(self.names[g], self.params(g)):
                sd[name] = opt.state.get(p, {}).get(key, torch.zeros_like(p))
        return sd

    def to_jax(self, model: nn.Module, cfg: DVGConfig) -> Dict[str, Any]:
        """The optimizer state as `dvg_tpu`'s TrainState.opt_states pytree
        (lists for tuples, f32 numpy moments in the JAX layouts, int32
        counts)."""
        mu = _groups(params_to_jax(self._moments(model, "exp_avg"), cfg)[0])
        nu = _groups(params_to_jax(self._moments(model, "exp_avg_sq"), cfg)[0])
        out = {}
        for g in MODULE_GROUPS:
            count = np.asarray(self.counts[g], np.int32)
            out[g] = [{"count": count, "mu": mu[g], "nu": nu[g]},
                      {"count": count} if g == "gp_group" else {}]
        return out

    def load_jax(self, opt_states: Dict[str, Any], stats: Dict,
                 cfg: DVGConfig) -> None:
        """Take over `dvg_tpu` optimizer state (the pytree form `to_jax`
        writes; `stats` is the checkpoint's BN-statistics tree, which the
        layout map reads alongside)."""
        adam = {g: opt_states[g][0] for g in MODULE_GROUPS}
        sched = int(np.asarray(opt_states["gp_group"][1]["count"]))
        if sched != int(np.asarray(adam["gp_group"]["count"])):
            raise ValueError(
                f"gp_group: schedule count {sched} differs from its Adam "
                f"count {int(np.asarray(adam['gp_group']['count']))}")
        mu = params_from_jax(_merged({g: adam[g]["mu"] for g in adam}), stats,
                             cfg)
        nu = params_from_jax(_merged({g: adam[g]["nu"] for g in adam}), stats,
                             cfg)
        for g in MODULE_GROUPS:
            count = int(np.asarray(adam[g]["count"]))
            self.counts[g] = count
            opt = self.adam[g]
            opt.state.clear()
            if count == 0:
                continue
            for name, p in zip(self.names[g], self.params(g)):
                opt.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": torch.empty_like(p).copy_(mu[name]),
                    "exp_avg_sq": torch.empty_like(p).copy_(nu[name])}


def _groups(params: Dict) -> Dict[str, Any]:
    """A `dvg_tpu` params tree → its four optimizer groups."""
    return {"frame_predictor": params["frame_predictor"],
            "encoder": params["encoder"], "decoder": params["decoder"],
            "gp_group": {"gp": params["gp"],
                         "likelihood": params["likelihood"]}}


def _merged(groups: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `_groups`."""
    return {"frame_predictor": groups["frame_predictor"],
            "encoder": groups["encoder"], "decoder": groups["decoder"],
            "gp": groups["gp_group"]["gp"],
            "likelihood": groups["gp_group"]["likelihood"]}
