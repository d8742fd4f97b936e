"""The diverse eval protocol, plainly.

`diverse_scores` rolls chosen futures of a (T, B, H, W, C) clip batch as
the reference's `generate_frames.py` defines them: frames 0..n_past−2
warm the LSTM, the skips are those of frame n_past−2 for the whole free
run, the free run starts from x[n_past−1], and each step encodes the last
frame, advances the LSTM and decodes; on every step i (counted from 0 at
the first frame) with i % 15 == 0 the LSTM's prediction is replaced by a
GP sample of gp(h), h the encoding. Each step's frame is scored against
the true frame. The BatchNorm is the eval-mode one, unfolded."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference import metrics, nets
from benchmark.reference.noise import fork_noise

FORK_EVERY = 15


@torch.no_grad()
def diverse_scores(P, x: torch.Tensor, n_past: int, n_eval: int, seed: int,
                   sample_ids: Sequence[int], ops: nets.Ops = None,
                   block: int = 8) -> Dict[str, torch.Tensor]:
    """The (ssim, psnr, mse) of futures `sample_ids` of every clip of x,
    each (K, n_free, B) f32, rolled `block` futures at a time."""
    ops = ops or nets.Ops()
    bn = nets.eval_bn(P)
    x = x.float()
    t_all, b = x.shape[:2]
    n_free = n_eval - n_past
    fork = np.arange(n_past, n_eval) % FORK_EVERY == 0
    g_dim = P["gp.z"].shape[0]
    h_ctx, skips = nets.encode(P, x[:n_past].flatten(0, 1), ops, bn)
    h_ctx = h_ctx.reshape(n_past, b, -1)
    hidden = nets.lstm_zero(P, b, x.device)
    for t in range(n_past - 1):
        _, hidden = nets.lstm_step(P, hidden, h_ctx[t], ops)
    k = max(n_past - 2, 0)
    skip = [s.reshape((n_past, b) + s.shape[1:])[k] for s in skips]
    rows = torch.arange(b)
    out = {m: [] for m in ("ssim", "psnr", "mse")}
    for lo in range(0, len(sample_ids), block):
        sids = torch.as_tensor(list(sample_ids[lo:lo + block]))
        kk = len(sids)
        hid = tuple([a.repeat(kk, 1) for a in part] for part in hidden)
        sk = [s.repeat(kk, 1, 1, 1) for s in skip]
        x_in = x[n_past - 1].repeat(kk, 1, 1, 1)
        per = {m: [] for m in out}
        for t in range(n_free):
            h, _ = nets.encode(P, x_in, ops, bn)
            latent, hid = nets.lstm_step(P, hid, h, ops)
            if fork[t]:
                eps = fork_noise(seed, sids[:, None], t, rows[None, :], g_dim,
                                 device=x.device).reshape(kk * b, g_dim)
                latent = nets.gp_sample(P, h, eps, ops)
            x_in = nets.decode(P, latent, sk, ops, bn)
            s, q, m = metrics.scores(x[n_past + t],
                                     x_in.reshape((kk, b) + x_in.shape[1:]))
            per["ssim"].append(s)
            per["psnr"].append(q)
            per["mse"].append(m)
        for name in out:
            out[name].append(torch.stack(per[name], dim=1))
    return {name: torch.cat(v, dim=0) for name, v in out.items()}
