"""The diverse-generation eval (counterpart of `dvg_tpu/generate/rollout.py`:
`_context_phase`, `make_rollout_fns(...).diverse_metrics`, `best_of_n`).

`diverse_metrics` rolls S sampled futures of a (T, B, H, W, C) clip as one
loop over a merged sample-major (S·B) batch (row s·B + b):
  * context: frames 0..n_past−2 warm the LSTM; the skips are frozen at
    frame n_past−2; the free run starts from x_in = x[n_past−1];
  * every step encodes x_in, advances the LSTM, and on the fork steps
    (step % 15 == 0 for step in n_past..n_eval−1) replaces the LSTM's
    prediction with a GP sample of gp(h) — h = enc(x_in), not the
    prediction — then decodes with the skip halves hoisted out of the loop;
  * every step scores its frames against the f32 ground truth through K1
    (ops/ssim_cuda.py): SSIM, PSNR and MSE per (sample, row).
Returns {"ssim", "psnr", "mse"}, each (S, n_free, B) f32.

GP noise: `noise` (n_free, S, B, g_dim) holds eps for every step (only the
fork steps read it). Without it, eps is drawn per fork step, in step
order, as randn(S, B, g_dim) from a torch.Generator on the run's device
seeded by `seed`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from dvg_tpu_torch.config import DVGConfig, compute_dtype, resolve_device
from dvg_tpu_torch.models import gp as gp_mod
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.models.rnn import Hidden
from dvg_tpu_torch.ops.ssim_cuda import ssim_psnr_batch_cyclic

FORK_EVERY = 15


class RolloutFns(NamedTuple):
    # (x, seed, noise, device) -> {"ssim", "psnr", "mse": (S, n_free, B)}
    diverse_metrics: Callable


def _context_phase(model: DVGModel, x: torch.Tensor, n_past: int
                   ) -> Tuple[Hidden, List[torch.Tensor], torch.Tensor]:
    """Teacher-forced warm-up of x (T, B, H, W, C) → (hidden after feeding
    h(x[0..n_past−2]), skips of frame n_past−2, x_in = x[n_past−1])."""
    b = x.shape[1]
    h_ctx, skips = model.encode(x[:n_past].reshape((-1,) + x.shape[2:]))
    h_ctx = h_ctx.reshape(n_past, b, -1)
    hidden = model.lstm_hidden_init(b, dtype=h_ctx.dtype)
    for t in range(n_past - 1):
        _, hidden = model.predict_latent(hidden, h_ctx[t])
    k = max(n_past - 2, 0)
    skip = [s.reshape((n_past, b) + s.shape[1:])[k] for s in skips]
    return hidden, skip, x[n_past - 1]


def fork_schedule(n_past: int, n_eval: int) -> np.ndarray:
    """(n_free,) bool: the free-run steps that decode a GP sample."""
    return np.arange(n_past, n_eval) % FORK_EVERY == 0


def make_rollout_fns(model: DVGModel, cfg: DVGConfig) -> RolloutFns:
    """cfg.dtype='bfloat16' runs the convs, the LSTM and the GP sample in
    bf16; the metrics are f32 against the f32 ground truth."""
    if cfg.last_frame_skip:
        raise NotImplementedError(
            "last_frame_skip (refreshed skips) is not ported yet: ROADMAP "
            "queue 1 item 9")
    if cfg.full_cov_sampling:
        raise NotImplementedError(
            "full_cov_sampling is not ported yet: ROADMAP queue 1 item 9")
    if cfg.eval_metric != "skimage":
        raise NotImplementedError(
            f"eval_metric={cfg.eval_metric!r} is not ported yet: ROADMAP "
            "queue 1 item 6")
    if not cfg.use_pallas:
        raise NotImplementedError(
            "the metric route without the hand-written kernel "
            "(use_pallas=False, expanded-form MSE) is not ported: ROADMAP "
            "queue 1 item 7; set use_pallas=True")
    n_past, n_eval = cfg.n_past, cfg.n_eval
    n_free = n_eval - n_past
    s_n = cfg.nsample
    dtype = compute_dtype(cfg)
    fork = fork_schedule(n_past, n_eval)

    def prep() -> Tuple[DVGModel, gp_mod.GPCache]:
        """Fold eval-mode BN into the convs and build the GP cache, both in
        f32, then cast weights and cache to the compute dtype."""
        folded = model.fold_inference_params()
        cache = folded.gp_cache().to(dtype)
        return folded.to(dtype=dtype, memory_format=torch.channels_last), cache

    @torch.inference_mode()
    def diverse_metrics(x, seed: int = 0, noise=None, device="cuda"
                        ) -> Dict[str, torch.Tensor]:
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(
                f"model is on {model.device}, the run asked for {dev}")
        x = torch.as_tensor(x, device=model.device)
        if x.dim() != 5 or x.shape[0] < n_eval:
            raise ValueError(f"x must be (T >= {n_eval}, B, H, W, C), got "
                             f"{tuple(x.shape)}")
        b = x.shape[1]
        d = cfg.g_dim
        if noise is not None:
            noise = torch.as_tensor(noise, device=model.device)
            if tuple(noise.shape) != (n_free, s_n, b, d):
                raise ValueError(f"noise must be {(n_free, s_n, b, d)}, got "
                                 f"{tuple(noise.shape)}")
        else:
            gen = torch.Generator(device=model.device).manual_seed(seed)

        gt = x[n_past:n_eval].float().contiguous()     # metrics vs f32 truth
        m, cache = prep()
        x = x.to(dtype)
        hidden_b, skip_b, x_in_b = _context_phase(m, x, n_past)

        # merged sample-major batch; the hoisted skip halves are computed at
        # batch B and tiled ONCE, so the in-loop add is shape-equal
        hidden = tuple(a.repeat(1, s_n, 1) for a in hidden_b)
        x_in = x_in_b.repeat(s_n, 1, 1, 1)
        skip_pre = [p.repeat(s_n, 1, 1, 1) for p in m.decode_skip_pre(skip_b)]

        out = torch.empty((3, s_n, n_free, b), dtype=torch.float32,
                          device=model.device)
        for t in range(n_free):
            h, _ = m.encode(x_in)
            latent, hidden = m.predict_latent(hidden, h)
            if fork[t]:
                if noise is None:
                    eps = torch.randn((s_n, b, d), generator=gen,
                                      device=model.device)
                else:
                    eps = noise[t]
                eps = eps.to(dtype).reshape(s_n * b, d).transpose(0, 1)
                latent = m.from_gp_layout(gp_mod.cached_rsample(
                    cache, m.to_gp_layout(h), eps))
            x_in = m.decode_hoisted(latent, skip_pre)
            s_v, q_v, m_v = ssim_psnr_batch_cyclic(gt[t], x_in.contiguous())
            out[:, :, t] = torch.stack([s_v, q_v, m_v]).reshape(3, s_n, b)
        return {"ssim": out[0], "psnr": out[1], "mse": out[2]}

    return RolloutFns(diverse_metrics=diverse_metrics)


def best_of_n(metric_bst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """metric (B, S, T) → (best sample index per row by mean over T, that
    mean). Ties go to the LAST maximal sample."""
    mean_bs = metric_bst.mean(dim=-1)
    s = mean_bs.shape[-1]
    idx = (s - 1) - torch.argmax(mean_bs.flip(-1), dim=-1)
    return idx, torch.gather(mean_bs, 1, idx[:, None])[:, 0]
