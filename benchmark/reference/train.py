"""DVG's training step, plainly, one module call at a time.

Per batch x (T, B, H, W, C), three passes (shgaurav1/DVG train.py, with
every pass taking fresh gradients):

  * joint: for each step i = 1..T−1 encode x[i−1] and x[i] (train-mode
    BatchNorm over the batch), predict h_i from the LSTM fed h_0..h_{i−1}
    teacher-forced, take the GP's ELBO of h_i given h_{i−1} and its
    predictive mean, and decode the LSTM's prediction, the target h_i and
    the GP mean against the skips of frame min(i−1, n_past−2);
        loss = 1000·ae_mse + 0.001·mse + 0.01·mse_latent + 0.001·mse_gp
               + 0.0001·(−Σ ELBO),
    each mse summed over the steps; then Adam steps all four groups;
  * LSTM finetune: the encodes again without gradient, Σ mse_latent of the
    teacher-forced LSTM, Adam on the LSTM alone;
  * GP finetune: Σ −ELBO over the same latents, Adam on the GP and the
    likelihood, whose learning rate follows MultiStepLR over epochs.

Each BatchNorm's running statistics move once per call, r ← 0.9·r + 0.1·s
with the batch's mean and unbiased variance, in the order the calls are
made; the GP pass re-encodes, so the encoder's statistics move once more.
Adam is written out: m ← β1·m + (1−β1)·g, v ← β2·v + (1−β2)·g²,
p ← p − lr/(1−β1^t) · m / (√v/√(1−β2^t) + 1e-8); a parameter a pass does
not reach takes a zero gradient.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import nets

GROUPS = ("frame_predictor", "encoder", "decoder", "gp_group")
BETA2 = 0.999
EPS = 1e-8
GP_BETA1 = 0.9


def group_of(name: str) -> str:
    head = name.split(".")[0]
    return "gp_group" if head in ("gp", "likelihood") else head


def is_param(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))


class Adam:
    """Fresh, or from `state` {"m", "v": per leaf, "t": updates per group}."""

    def __init__(self, P: Dict[str, torch.Tensor], hp: Dict,
                 state: Optional[Dict] = None):
        self.P = P
        self.hp = hp
        keys = [k for k in P if is_param(k)]
        if state is None:
            self.m = {k: torch.zeros_like(P[k]) for k in keys}
            self.v = {k: torch.zeros_like(P[k]) for k in keys}
            self.t = {g: 0 for g in GROUPS}
        else:
            self.m = {k: state["m"][k].detach().clone().float() for k in keys}
            self.v = {k: state["v"][k].detach().clone().float() for k in keys}
            self.t = dict(state["t"])

    def beta1(self, group: str) -> float:
        return GP_BETA1 if group == "gp_group" else self.hp["beta1"]

    def gp_lr(self) -> float:
        # two GP updates per batch with the finetune passes
        epoch = (self.t["gp_group"] // 2) // self.hp["epoch_size"]
        factor = 1.0
        for mile in self.hp["gp_lr_milestones"]:
            if epoch + 1 >= mile:
                factor *= self.hp["gp_lr_gamma"]
        return self.hp["gp_lr"] * factor

    @torch.no_grad()
    def step(self, group: str) -> None:
        lr = self.gp_lr() if group == "gp_group" else self.hp["lr"]
        b1 = self.beta1(group)
        self.t[group] += 1
        t = self.t[group]
        for k in self.m:
            if group_of(k) != group:
                continue
            p = self.P[k]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(BETA2).add_((1 - BETA2) * g * g)
            denom = self.v[k].sqrt() / (1 - BETA2 ** t) ** 0.5 + EPS
            p.sub_(lr / (1 - b1 ** t) * self.m[k] / denom)
            p.grad = None


def _encode_frames(P, x, ops, bn):
    hs, skips = [], []
    for t in range(x.shape[0]):
        h, s = nets.encode(P, x[t], ops, bn)
        hs.append(h)
        skips.append(s)
    return hs, skips


def _teacher_forced(P, hs: List[torch.Tensor], ops) -> List[torch.Tensor]:
    hidden = nets.lstm_zero(P, hs[0].shape[0], hs[0].device)
    preds = []
    for h in hs[:-1]:
        out, hidden = nets.lstm_step(P, hidden, h, ops)
        preds.append(out)
    return preds


def _encode_in_call_order(P, x, ops, bn: nets.TrainBN):
    """Encode x[i−1] then x[i] for i = 1..T−1 (frame 0 once, the last once,
    the others twice): the latents and skips of each frame, and the calls'
    statistics in the reference's order."""
    t_len = x.shape[0]
    start = len(bn.calls)
    hs, skips = _encode_frames(P, x, ops, bn)
    by_frame = bn.calls[start:]
    del bn.calls[start:]
    order = [0] + [i for i in range(1, t_len)
                   for _ in range(2 if i < t_len - 1 else 1)]
    block = len(by_frame) // t_len
    for f in order:
        bn.calls.extend(by_frame[f * block:(f + 1) * block])
    return hs, skips


def joint_loss(P, x, n_past: int, ops) -> tuple:
    bn = nets.TrainBN(P)
    hs, skips = _encode_in_call_order(P, x, ops, bn)
    t_len, b = x.shape[0], x.shape[1]
    preds = _teacher_forced(P, hs, ops)
    mse = ae = mse_gp = lat = torch.zeros((), device=x.device)
    max_ll = torch.zeros((), device=x.device)
    for i in range(1, t_len):
        elbo, gp_mean = nets.gp_elbo(P, hs[i - 1].T, hs[i].T, b)
        max_ll = max_ll - elbo.sum()
        sk = skips[min(i - 1, max(n_past - 2, 0))]
        target = x[i]
        for kind, latent in (("mse", preds[i - 1]), ("ae", hs[i]),
                             ("gp", gp_mean.T)):
            err = torch.mean((nets.decode(P, latent, sk, ops, bn)
                              - target) ** 2)
            if kind == "mse":
                mse = mse + err
            elif kind == "ae":
                ae = ae + err
            else:
                mse_gp = mse_gp + err
        lat = lat + torch.mean((preds[i - 1] - hs[i]) ** 2)
    loss = (1000.0 * ae + 0.001 * mse + 0.01 * lat + 0.001 * mse_gp
            + 0.0001 * max_ll)
    return loss, bn.calls


def train_steps(P: Dict[str, torch.Tensor], batches: Sequence[torch.Tensor],
                hp: Dict, ops: nets.Ops = None, adam: Optional[Dict] = None
                ) -> Dict:
    """Run len(batches) steps on a copy of P (parameters and BatchNorm
    statistics), Adam fresh or from `adam` → {"losses": [joint loss per
    step], "m1": Adam's first moments after step 1, "decay": per leaf the
    factor step 1 put on the moment it started from (β1 to the group's
    updates in a step), "state": parameters and statistics after the last
    step}."""
    ops = ops or nets.Ops()
    P = {k: v.detach().clone().float() for k, v in P.items()
         if not k.endswith("num_batches_tracked")}
    for k, v in P.items():
        v.requires_grad_(is_param(k))
    opt = Adam(P, hp, adam)
    t0 = dict(opt.t)
    losses, m1, decay = [], None, None
    for step, x in enumerate(batches):
        x = x.float()
        loss, calls = joint_loss(P, x, hp["n_past"], ops)
        loss.backward()
        nets.fold_running(P, calls)
        for g in GROUPS:
            opt.step(g)
        losses.append(float(loss.detach()))
        if hp["ft"]:
            bn = nets.TrainBN(P)
            with torch.no_grad():
                hs, _ = _encode_in_call_order(P, x, ops, bn)
            hs = [h.detach() for h in hs]
            preds = _teacher_forced(P, hs, ops)
            ft = sum(torch.mean((p - h) ** 2) for p, h in zip(preds, hs[1:]))
            ft.backward()
            nets.fold_running(P, bn.calls)
            opt.step("frame_predictor")
            b = x.shape[1]
            ft_gp = -sum(nets.gp_elbo(P, hs[i - 1].T, hs[i].T, b)[0].sum()
                         for i in range(1, len(hs)))
            ft_gp.backward()
            nets.fold_running(P, bn.calls)
            opt.step("gp_group")
        if step == 0:
            m1 = {k: v.clone() for k, v in opt.m.items()}
            decay = {k: opt.beta1(group_of(k)) ** (opt.t[group_of(k)]
                                                   - t0[group_of(k)])
                     for k in m1}
    state = {k: v.detach() for k, v in P.items()}
    return {"losses": losses, "m1": m1, "decay": decay, "state": state}
