"""The seeded GP fork noise, a frozen copy of the formula the model's
generation is defined by: eps for (seed, sample id, free-run step, global
row id, latent index) is a pure function of those ids, integer hashing
(Wellons' lowbias32) into two 24-bit uniforms, then Box–Muller in f64."""

from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _MASK32
    return x ^ (x >> 15)


def _scalar_key(*words):
    h = 0
    for w in words:
        w = w.to(torch.int64) if isinstance(w, torch.Tensor) else int(w)
        h = _mix32(h ^ ((w ^ (w >> 32)) & _MASK32))
    return h


def fork_noise(seed, sample_ids, step, row_ids, dim: int, device="cpu"
               ) -> torch.Tensor:
    """Standard-normal eps (broadcast(sample_ids, row_ids) + (dim,)) f32."""
    dev = torch.device(device)
    ids = torch.broadcast_tensors(
        torch.as_tensor(sample_ids, dtype=torch.int64, device=dev),
        torch.as_tensor(row_ids, dtype=torch.int64, device=dev))
    salt = torch.as_tensor(_scalar_key(0x5EED, seed, step), device=dev)
    pair = _mix32(salt ^ (ids[0] & _MASK32))
    pair = _mix32(pair ^ _mix32(ids[1] & _MASK32))
    lane = _mix32(torch.arange(2 * dim, dtype=torch.int64, device=dev)
                  + 0x9E3779B)
    bits = _mix32(pair[..., None] ^ lane) >> 8
    u = bits.to(torch.float64).unflatten(-1, (dim, 2))
    u1 = (u[..., 0] + 1.0) * 2.0 ** -24
    u2 = u[..., 1] * 2.0 ** -24
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return eps.float()
