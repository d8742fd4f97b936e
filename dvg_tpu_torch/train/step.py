"""The port's DVG train step (counterpart of `dvg_tpu/train/step.py`):
three gradient passes per batch, on one device or data parallel over a
process group (`make_train_step(cfg, group)`).

  * joint pass: teacher-forced over t = 1..T−1,
      loss = 1000·ae_mse + 0.001·mse + 0.01·mse_latent + 0.001·mse_gp
             + 0.0001·max_ll,
    then all four optimizer groups step;
  * LSTM finetune pass: Σ mse_latent over the latents of one shared encode
    (no gradient to the encoder), only the frame_predictor steps;
  * GP finetune pass: Σ(−ELBO) over the same latents, only gp + likelihood
    step.
  The two finetune passes run when cfg.ft (the default). As in `dvg_tpu`,
  every pass computes fresh gradients (`dvg_tpu`'s documented deviation
  from the reference, whose joint pass reused the GP group's gradients of
  the previous batch's finetune pass).

Batched as in `dvg_tpu`: the T-frame encode is one conv pass over T·B
images with per-frame train-mode BN statistics; the 3·(T−1) decoder calls
of the joint pass are one grouped decode (`Decoder.grouped`); the LSTM is
teacher-forced, so only its recurrence is sequential; the GP sees the T−1
steps as one batched ELBO.

BatchNorm running statistics are folded in closed form: the reference
applies r ← (1−m)·r + m·s_k once per module call k in a fixed order, which
telescopes to r_N = (1−m)^N·r_0 + Σ_k m·(1−m)^(N−1−k)·s_k. The orders are
the reference's: each pass encodes frames [0, 1, 1, 2, 2, …, T−1] (the
interior frames twice), the decoder's calls run time-major over the three
variants, and the GP pass folds the shared encode's statistics a second
time. The weights are host-side f64, computed once per clip length.

cfg.dtype "bfloat16" is `dvg_tpu`'s mixed precision: the encoder, decoder
and LSTM weights and the clip are cast to bf16 by differentiable casts over
the f32 masters; the GP, the likelihood, the BN statistics and every loss
stay in at least f32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dvg_tpu_torch.config import DVGConfig, compute_dtype
from dvg_tpu_torch.models import gp as gp_mod
from dvg_tpu_torch.models import layers as L
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.parallel.collectives import all_reduce_mean_, world_size
from dvg_tpu_torch.train.optim import MODULE_GROUPS, Optimizers
from dvg_tpu_torch.utils.profiling import span

VARIANTS = 3      # decoded latents per step: LSTM prediction, target, GP mean

Metrics = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# BatchNorm running-statistics fold
# ---------------------------------------------------------------------------

def ema_weights(order: Sequence[int], n_slots: int,
                momentum: float = L.BN_MOMENTUM) -> Tuple[np.ndarray, float]:
    """weights[j] = Σ_{k: order[k] = j} m·(1−m)^(N−1−k) and the decay
    (1−m)^N of the N calls in `order`, in f64."""
    n = len(order)
    w = np.zeros((n_slots,), np.float64)
    for k, j in enumerate(order):
        w[j] += momentum * (1.0 - momentum) ** (n - 1 - k)
    return w, (1.0 - momentum) ** n


def encode_order(seq_len: int) -> List[int]:
    """The reference's encode order of one pass, x[i−1] then x[i] per step:
    [0, 1, 1, 2, 2, …, T−1]."""
    order = [0]
    for i in range(1, seq_len):
        order.extend([i] * (2 if i < seq_len - 1 else 1))
    return order


def decoder_call_order(variants: int, tm1: int) -> List[int]:
    """The grouped decoder's calls (variant-major: call s·(T−1) + i decodes
    variant s of step i) in the reference's call order, where the V
    variants of each step run back to back."""
    return [s * tm1 + i for i in range(tm1) for s in range(variants)]


@torch.no_grad()
def fold_stats(blocks: Sequence[L.ConvBlock], per_call: Sequence[L.BNStats],
               weights: torch.Tensor, decay: float) -> None:
    """r ← decay·r + Σ_k weights[k]·s_k for the mean and the unbiased
    variance of every block's BN, in place."""
    for block, (mean, var) in zip(blocks, per_call, strict=True):
        w = weights.to(mean.dtype)
        block.bn.running_mean.mul_(decay).add_(w @ mean)
        block.bn.running_var.mul_(decay).add_(w @ var)


# ---------------------------------------------------------------------------
# batched sweeps
# ---------------------------------------------------------------------------

def skip_index(seq_len: int, n_past: int, last_frame_skip: bool
               ) -> np.ndarray:
    """The skip source frame of each step i = 1..T−1: frame i−1 while
    i < n_past, then frozen at frame n_past−2."""
    if last_frame_skip:
        return np.arange(0, seq_len - 1)
    return np.minimum(np.arange(0, seq_len - 1), max(n_past - 2, 0))


class Plan(NamedTuple):
    """What a step needs per clip length, built once on the device so that
    no step copies from the host (a host-to-device copy of pageable
    memory waits for the card)."""
    dtype: Optional[torch.dtype]   # the compute cast; None keeps the params'
    uniq: torch.Tensor             # (U,) frames whose skips the decoder reads
    group_idx: torch.Tensor        # (V·(T−1),) decoder call → unique frame
    enc_w: torch.Tensor            # (T,) f64 encode-fold weights
    enc_decay: float
    dec_w: torch.Tensor            # (V·(T−1),) f64 decoder-fold weights
    dec_decay: float


def make_plan(cfg: DVGConfig, seq_len: int, device) -> Plan:
    dtype = torch.bfloat16 if compute_dtype(cfg) == torch.bfloat16 else None
    uniq, inv = np.unique(skip_index(seq_len, cfg.n_past,
                                     cfg.last_frame_skip),
                          return_inverse=True)
    enc_w, enc_decay = ema_weights(encode_order(seq_len), seq_len)
    n = VARIANTS * (seq_len - 1)
    dec_w, dec_decay = ema_weights(decoder_call_order(VARIANTS, seq_len - 1),
                                   n)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return Plan(dtype, dev(uniq), dev(np.tile(inv, VARIANTS)), dev(enc_w),
                enc_decay, dev(dec_w), dec_decay)


def encode_frames(model: DVGModel, x: torch.Tensor, dtype, remat: bool,
                  group=None) -> Tuple[torch.Tensor, List[torch.Tensor],
                                       List[L.BNStats]]:
    """All T frames of x (T, B, H, W, C) in one train-mode encode, each
    frame normalized by its own batch statistics (the global batch's under
    a process `group`) → (h (T, B, G), skips (T, B, h, w, c) per stage,
    per-frame statistics (T, C) per block). `remat` recomputes the
    encoder's activations in the backward instead of keeping them."""
    t, b = x.shape[:2]

    def enc(flat):
        return model.encoder.train_forward(flat, t, dtype, group)

    flat = x.flatten(0, 1)
    h, skips, stats = (checkpoint(enc, flat, use_reentrant=False) if remat
                       else enc(flat))
    return (h.unflatten(0, (t, b)), [s.unflatten(0, (t, b)) for s in skips],
            stats)


def decode_variants(model: DVGModel, latents: torch.Tensor,
                    skips: List[torch.Tensor], plan: Plan, remat: bool,
                    group=None) -> Tuple[torch.Tensor, List[L.BNStats]]:
    """Decode the (V, T−1, B, G) latent variants in one grouped train-mode
    decode (step i reads the skips of frame skip_index[i]) → (frames (V,
    T−1, B, H, W, C), per-call statistics (V·(T−1), C) per block, the calls
    variant-major)."""
    v, tm1 = latents.shape[:2]
    skips_u = [s.index_select(0, plan.uniq) for s in skips]

    def dec(lat, *sk):
        return model.decoder.grouped(lat, list(sk), plan.group_idx,
                                     plan.dtype, group)

    lat = latents.flatten(0, 1)
    frames, stats = (checkpoint(dec, lat, *skips_u, use_reentrant=False)
                     if remat else dec(lat, *skips_u))
    return frames.unflatten(0, (v, tm1)), stats


def ranks(group) -> int:
    """The ranks a step's batch is split over: 1 without a group (also in a
    process where a default group is up), else the group's size."""
    return 1 if group is None else world_size(group)


def gp_pairs(h_all: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, B, G) → per-step GP task-layout pairs x (T−1, G, B, 1), y (T−1,
    G, B), time a leading batch axis."""
    return h_all[:-1].transpose(1, 2)[..., None], h_all[1:].transpose(1, 2)


# ---------------------------------------------------------------------------
# loss passes
# ---------------------------------------------------------------------------

def joint_loss(model: DVGModel, x: torch.Tensor, cfg: DVGConfig, plan: Plan,
               group=None) -> Tuple[torch.Tensor, Metrics, List[L.BNStats],
                                    List[L.BNStats]]:
    """The joint pass's loss on x (T, B, H, W, C) in the params' dtype →
    (loss, metrics, per-frame encoder statistics, per-call decoder
    statistics). Under a process `group` x is this rank's rows of the
    global batch: BN's statistics and the GP's num_data are the global
    batch's, and the loss is this rank's, whose gradients the ranks
    average (`make_train_step`)."""
    xc = L.cast(x, plan.dtype)
    seq_len, b = x.shape[:2]
    tm1 = seq_len - 1
    h_all, skips, enc_stats = encode_frames(model, xc, plan.dtype, cfg.remat,
                                            group)
    h_pred = model.frame_predictor.teacher_forced(h_all[:-1], plan.dtype)
    h_target = h_all[1:]

    gx, gy = gp_pairs(L.f32up(h_all))
    post = gp_mod.posterior(model.gp, gx)
    max_ll = -gp_mod.elbo(model.gp, model.likelihood, gx, gy,
                          b * ranks(group), post).sum()
    gp_mean = post.mean.transpose(1, 2).to(h_pred.dtype)

    latents = torch.stack([h_pred, h_target, gp_mean])
    frames, dec_stats = decode_variants(model, latents, skips, plan,
                                        cfg.remat, group)
    frames = L.f32up(frames)
    x_true = L.f32up(xc[1:])
    mse = torch.mean((frames[0] - x_true) ** 2) * tm1
    ae_mse = torch.mean((frames[1] - x_true) ** 2) * tm1
    mse_gp = torch.mean((frames[2] - x_true) ** 2) * tm1
    mse_latent = torch.mean((L.f32up(h_pred) - L.f32up(h_target)) ** 2) * tm1
    loss = (1000.0 * ae_mse + 0.001 * mse + 0.01 * mse_latent
            + 0.001 * mse_gp + 0.0001 * max_ll)
    metrics = {"loss": loss, "mse": mse, "ae_mse": ae_mse, "mse_gp": mse_gp,
               "mse_latent": mse_latent, "max_ll": max_ll,
               # the reference's printed epoch metric
               "mse_latent_per_frame": mse_latent / seq_len}
    return loss, {k: v.detach() for k, v in metrics.items()}, enc_stats, \
        dec_stats


@torch.no_grad()
def finetune_encode(model: DVGModel, x: torch.Tensor, plan: Plan,
                    group=None) -> Tuple[torch.Tensor, List[L.BNStats]]:
    """The one encode both finetune passes share: the encoder's parameters
    are the same for both (pass 2 steps only the LSTM, pass 3 only the GP
    group) and train-mode BN normalizes by batch statistics, so their
    latents are identical, and neither pass sends a gradient into them."""
    h_all, _, stats = encode_frames(model, L.cast(x, plan.dtype), plan.dtype,
                                    remat=False, group=group)
    return h_all, stats


def lstm_finetune_loss(model: DVGModel, h_all: torch.Tensor, plan: Plan
                       ) -> torch.Tensor:
    """Σ_t mse_latent of the teacher-forced LSTM over fixed latents."""
    h_pred = model.frame_predictor.teacher_forced(h_all[:-1], plan.dtype)
    return torch.mean((L.f32up(h_pred) - L.f32up(h_all[1:])) ** 2) * (
        h_all.shape[0] - 1)


def gp_finetune_loss(model: DVGModel, h_all: torch.Tensor,
                     num_data: Optional[int] = None) -> torch.Tensor:
    """Σ_t −ELBO of the GP over fixed latents, num_data the batch (the
    global batch under data parallelism)."""
    gx, gy = gp_pairs(L.f32up(h_all))
    return -gp_mod.elbo(model.gp, model.likelihood, gx, gy,
                        num_data or h_all.shape[1]).sum()


# ---------------------------------------------------------------------------
# train state + step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its four optimizer groups
    and the number of steps taken: `dvg_tpu`'s TrainState, held in torch
    objects that the step updates in place."""
    model: DVGModel
    opts: Optimizers
    step: int = 0


def train_state(model: DVGModel, cfg: DVGConfig, step: int = 0
                ) -> TrainState:
    """A TrainState around `model` (moved to channels_last, the convs'
    layout) with fresh optimizers."""
    model.to(memory_format=torch.channels_last)
    return TrainState(model, Optimizers(cfg, model), step)


def init_train_state(cfg: DVGConfig, device="cuda") -> TrainState:
    """Weights seeded by cfg.seed (`DVGModel`'s init law) on `device`,
    which defaults to the card and raises without one."""
    return train_state(DVGModel(cfg, seed=cfg.seed, device=device), cfg)


def make_train_step(cfg: DVGConfig, group=None) -> Callable[
        [TrainState, torch.Tensor], Tuple[TrainState, Metrics]]:
    """step(state, x) → (state, metrics): the joint pass and, with cfg.ft,
    the two finetune passes on x (T, B, H, W, C), updating `state` in place
    and leaving the metrics on the device (reading one waits for the
    step).

    Data parallel under a process `group` (`dvg_tpu`'s make_train_step
    with a mesh): x is this rank's B/W rows of the global batch, BN's
    statistics and the GP's num_data are the global batch's, each optimizer
    group's gradients are averaged over the ranks in one flat all-reduce
    before its update, and the metrics are the ranks' mean. Every rank
    ends the step with the same weights, BN statistics and Adam state: the
    step of one rank on the global batch.

    Spans (`utils.profiling.span`): `dvg.train.step` around the step;
    inside it `dvg.train.joint.forward` and `.backward`, `dvg.train.ft.encode`,
    `dvg.train.ft.lstm` and `dvg.train.ft.gp` (each finetune loss and its
    backward), one `dvg.train.bn_fold` per pass, one `dvg.train.optim` per
    group update, and `dvg.train.allreduce` under a group."""
    plans: Dict[Tuple[int, torch.device], Plan] = {}
    sync = group is not None

    @span("dvg.train.allreduce")
    def mean_grads(opts: Optimizers, g: str) -> None:
        """Average group g's gradients over the ranks (a parameter the pass
        did not reach takes a zero gradient first, as Optimizers.step
        would give it)."""
        params = opts.params(g)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_mean_([p.grad for p in params], group)

    @span("dvg.train.step")
    def step_fn(state: TrainState, x) -> Tuple[TrainState, Metrics]:
        model, opts = state.model, state.opts
        x = torch.as_tensor(x, device=model.device, dtype=model.gp.z.dtype)
        key = (x.shape[0], x.device)
        if key not in plans:
            plans[key] = make_plan(cfg, x.shape[0], x.device)
        plan = plans[key]
        enc_blocks = model.encoder.bn_blocks()

        # ---- pass 1: joint ------------------------------------------------
        opts.zero_grad()
        with span("dvg.train.joint.forward"):
            loss, metrics, enc_stats, dec_stats = joint_loss(model, x, cfg,
                                                             plan, group)
        with span("dvg.train.joint.backward"):
            loss.backward()
        with span("dvg.train.bn_fold"):
            fold_stats(enc_blocks, enc_stats, plan.enc_w, plan.enc_decay)
            fold_stats(model.decoder.bn_blocks(), dec_stats, plan.dec_w,
                       plan.dec_decay)
        for g in MODULE_GROUPS:
            if sync:
                mean_grads(opts, g)
            opts.step(g)

        if cfg.ft:
            with span("dvg.train.ft.encode"):
                h_all, enc_stats = finetune_encode(model, x, plan, group)
            # ---- pass 2: LSTM only ----------------------------------------
            with span("dvg.train.ft.lstm"):
                opts.zero_grad("frame_predictor")
                ft_latent = lstm_finetune_loss(model, h_all, plan)
                ft_latent.backward()
            with span("dvg.train.bn_fold"):
                fold_stats(enc_blocks, enc_stats, plan.enc_w, plan.enc_decay)
            if sync:
                mean_grads(opts, "frame_predictor")
            opts.step("frame_predictor")
            # ---- pass 3: GP only; the reference re-encodes here, so the
            # shared encode's statistics fold a second time ---------------
            with span("dvg.train.ft.gp"):
                opts.zero_grad("gp_group")
                ft_gp = gp_finetune_loss(model, h_all,
                                         x.shape[1] * ranks(group))
                ft_gp.backward()
            with span("dvg.train.bn_fold"):
                fold_stats(enc_blocks, enc_stats, plan.enc_w, plan.enc_decay)
            if sync:
                mean_grads(opts, "gp_group")
            opts.step("gp_group")
            metrics.update(ft_mse_latent=ft_latent.detach(),
                           ft_gp_nll=ft_gp.detach())
        if sync:
            with span("dvg.train.allreduce"):
                all_reduce_mean_(list(metrics.values()), group)
        state.step += 1
        return state, metrics

    return step_fn
