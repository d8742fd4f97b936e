"""The generation engine (counterpart of `dvg_tpu/generate/rollout.py`):
`make_rollout_fns(model, cfg)` → posterior, diverse, diverse_metrics,
diverse_select, diverse_select_pairs, diverse_rollout_with_keys,
plot_samples and gp_trigger; and `best_of_n`.

Every path rolls `prepare()`'s copy of the model, each BatchNorm folded
into its conv (`DVGModel.fold_inference_params()`): the one form the eval
forward runs. Every sampled path rolls its K futures of a (T, B, H, W, C)
clip as one loop over a merged sample-major (K·B) batch (row k·B + b):
  * context: frames 0..n_past−2 warm the LSTM; the skips are frozen at
    frame n_past−2; the free run starts from x_in = x[n_past−1];
  * every step encodes x_in, advances the LSTM, and on the fork steps
    (step % 15 == 0 for step in n_past..n_eval−1; plot_samples: step == 10)
    replaces the LSTM's prediction with a GP sample of gp(h) — h = enc(x_in),
    not the prediction — then decodes with the skip halves hoisted out of
    the loop (`cfg.last_frame_skip`: the skips refresh from every step's
    encode and the decode is the fused one). A free step that does not
    refresh its skips encodes without them (`DVGModel.encode(x,
    skips=False)`): VGG's encoder then pools each group inside its last
    conv's epilogue, and its decoders run each ×2 upsample folded into a
    transposed conv (models/vgg.py), so the eval step runs no resampling
    op;
  * `diverse_metrics` scores every step's frames against the f32 ground
    truth and returns {"ssim", "psnr", "mse"}, each (S, n_free, B) f32, by
    one of three metric routes (`make_rollout_fns`); the other paths
    return frames.
`posterior` decodes the GP posterior mean of the LSTM's prediction at
every step. `gp_trigger` free-runs from x[0] without teacher forcing and
forks a row whenever its GP variance norm leaves a rolling window's band.

GP noise. Without `noise`, eps for (sample s, free-run step t, global row
r) is `models.gp.fork_noise(seed, s, t, r, g_dim)`, a pure function of
those ids: a re-roll of any subset of samples, rows or pairs reproduces
the futures that were scored (`row_offset` and `sample_offset` shift the
row and sample ids of a block of a larger grid). `gp_trigger` draws with
sample id 0 and the absolute step. With `cfg.full_cov_sampling` a fork
draws one sample correlated across the B rows of each future from the
same eps. `noise` holds eps explicitly instead (the parity tests pass the
JAX package's): (n_free, K, B, g_dim) for the batch paths, (n_free, K,
g_dim) for pairs, (n_eval − 12, B, g_dim) for gp_trigger; only the fork
steps read it.

Serving. `posterior`, `diverse_metrics` and `gp_trigger` are each a
core over `RolloutFns.prepare()`'s output (BN folded, cast, channels_last,
the GP caches), run under inference_mode; `serve/export.py` prepares
once and traces the core (`RolloutFns.cores`), whose seed and offsets may
be tensors. The entries prepare afresh on every call, so a model that
keeps training (the training CLI's plots) is always rolled with its
current weights.

Spans (`utils.profiling.span`): `dvg.eval.prepare` around `prepare()`;
in every rollout `dvg.eval.context` (the warm-up and the k-fold tiling),
then per free step `dvg.eval.encode`, `dvg.eval.lstm`, `dvg.eval.gp_draw`
(a fork's draw with its eps, or mean mode's posterior mean) and
`dvg.eval.decode`, each closed before the step's frames are yielded;
`diverse_metrics` adds `dvg.eval.score` per step. `gp_trigger`'s own loop
has none.

Sharded eval departs from `dvg_tpu` here, on purpose. `dvg_tpu`'s
sample-sharded run folds its key by device (dvg_tpu/parallel/mesh.py:
121-126), so it draws other futures than its unsharded run and its CLI
translates keys to re-roll them. The port's ranks pass their global
sample and row offsets instead (`parallel.shard_diverse_metrics`), so a
sharded eval draws, and scores, exactly the futures of the one-process
eval, and a re-roll needs no translation. Parity with `dvg_tpu`'s sharded
functions is held by passing each device's JAX eps through `noise`.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from dvg_tpu_torch.config import DVGConfig, compute_dtype, resolve_device
from dvg_tpu_torch.models import gp as gp_mod
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.models.rnn import Hidden
from dvg_tpu_torch.ops.ssim import (finn_ssim_psnr_batch, ssim_gt_precompute,
                                    ssim_psnr_batch_pre)
from dvg_tpu_torch.ops.ssim_cuda import ssim_psnr_batch_cyclic
from dvg_tpu_torch.utils.profiling import span

FORK_EVERY = 15
PLOT_FORK_STEP = 10      # the train-time plot forks once, at step 10
PLOT_SAMPLES = 5
TRIGGER_WARMUP = 12      # the GP-trigger's fixed free-run warm-up
TRIGGER_SKIP_FRAMES = 5  # ... whose skips come from its first 5 encodes

# eps of a fork step, by the step's index
EpsAt = Callable[[int], torch.Tensor]


class Prepared(NamedTuple):
    """What every rollout runs on: the model with eval-mode BN folded into
    its convs, cast to the compute dtype and in channels_last, and the GP
    cache in the compute dtype and in f32 (the full-covariance draw's)."""
    model: DVGModel
    cache: gp_mod.GPCache
    cache32: gp_mod.GPCache


class Cores(NamedTuple):
    """The traceable cores of the served entries: pure tensor code over a
    `Prepared`, with no module copy or cast, no grad-mode switch and no
    branch on tensor data. `seed`, `row_offset` and `sample_offset` may be
    ints or 0-dim int64 tensors (an exported program's inputs)."""
    # (prepared, x) -> (n_eval, B, H, W, C) f32
    posterior: Callable
    # (prepared, x, seed, row_offset, sample_offset, noise) ->
    #   {"ssim", "psnr", "mse": (S, n_free, B)}
    diverse_metrics: Callable
    # (prepared, x, seed, noise) -> (frames, diagnostics)
    gp_trigger: Callable


class RolloutFns(NamedTuple):
    # (x, device) -> (n_eval, B, H, W, C) f32
    posterior: Callable
    # (x, seed, noise, device) -> (S, n_eval, B, H, W, C) f32
    diverse: Callable
    # (x, seed, noise, device, row_offset, sample_offset) ->
    #   {"ssim", "psnr", "mse": (S, n_free, B)}, scored in the loop by the
    #   route cfg selects: K1 (use_pallas, the CLI's default), the skimage
    #   metric in stock torch ops (--no_pallas) or Finn's (--finn)
    diverse_metrics: Callable
    # (x, sample_ids (K,), row_ids (B,), seed, noise, device) ->
    #   (K, n_eval, B, H, W, C); refuses cfg.full_cov_sampling
    diverse_select: Callable
    # (x_sel (T, K, ...), sample_ids (K,), row_ids (K,), seed, noise,
    #   device) -> (n_eval, K, H, W, C): column k replays the pair
    #   (sample_ids[k], row_ids[k]); refuses cfg.full_cov_sampling
    diverse_select_pairs: Callable
    # as diverse_select over the full batch, full_cov included
    diverse_rollout_with_keys: Callable
    # (x, seed, noise, device) -> (5, n_eval, B, ...), fork at step 10
    plot_samples: Callable
    # (x, seed, noise, device) -> (frames (n_eval, B, ...), {"triggers",
    #   "values", "thresholds": (n_eval − 12, B), "warmup_values": (12, B)})
    gp_trigger: Callable
    # S, the futures diverse and diverse_metrics roll per clip
    nsample: int
    # () -> Prepared: the fold, cast and GP caches of the model's current
    #   weights, which every entry above makes afresh on each call
    prepare: Callable
    # the cores of posterior, diverse_metrics and gp_trigger: each entry is
    #   its core on prepare()'s output under inference_mode
    cores: Cores


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


def _ids(ids) -> torch.Tensor:
    ids = torch.as_tensor(ids, dtype=torch.int64).cpu()
    if ids.dim() != 1:
        raise ValueError(f"ids must be 1-D, got shape {tuple(ids.shape)}")
    return ids


def make_rollout_fns(model: DVGModel, cfg: DVGConfig) -> RolloutFns:
    """cfg.dtype='bfloat16' runs the convs, the LSTM and the GP sample in
    bf16; metrics and returned frames are f32.

    `diverse_metrics` scores each step by one of three routes, as the JAX
    package's does:
      * K1, the hand-written kernel (`ops/ssim_cuda.py`; its plain version
        on CPU tensors): eval_metric "skimage" with use_pallas. SSIM, PSNR
        and the direct Σ(x − g)² MSE in one pass. The CLI's default.
      * the skimage metric in stock torch ops: eval_metric "skimage"
        without use_pallas (CLI --no_pallas). The gt side's box moments
        are computed once per clip.
      * Finn's metric: eval_metric "finn" (CLI --finn), whatever
        use_pallas says. An 11×11 Gaussian window, L = 1.
    The last two compute MSE in the expanded form Σx² − 2·x·g + Σg², the
    cross term one batched f32 matmul, and broadcast the gt side over the
    S samples as views."""
    if cfg.eval_metric not in ("skimage", "finn"):
        raise ValueError(f"eval_metric must be 'skimage' or 'finn', got "
                         f"{cfg.eval_metric!r}")
    finn = cfg.eval_metric == "finn"
    use_kernel = bool(cfg.use_pallas) and not finn
    n_past, n_eval = cfg.n_past, cfg.n_eval
    n_free = n_eval - n_past
    s_n, d = cfg.nsample, cfg.g_dim
    dtype = compute_dtype(cfg)
    refresh = bool(cfg.last_frame_skip)
    fc = bool(cfg.full_cov_sampling)
    fork_15 = fork_schedule(n_past, n_eval)
    fork_10 = np.arange(n_past, n_eval) == PLOT_FORK_STEP

    @span("dvg.eval.prepare")
    @torch.no_grad()
    def prepare() -> Prepared:
        """Fold eval-mode BN into the convs and build the GP cache, both in
        f32, then cast weights and cache to the compute dtype. The f32
        cache is kept for the full-covariance draw
        (gp.cached_rsample_fullcov)."""
        folded = model.fold_inference_params()
        cache32 = folded.gp_cache()
        return Prepared(folded.to(dtype=dtype,
                                  memory_format=torch.channels_last),
                        cache32.to(dtype), cache32)

    def clip(x, device, min_t: int) -> torch.Tensor:
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(
                f"model is on {model.device}, the run asked for {dev}")
        x = torch.as_tensor(x, device=model.device)
        if x.dim() != 5 or x.shape[0] < min_t:
            raise ValueError(f"x must be (T >= {min_t}, B, H, W, C), got "
                             f"{tuple(x.shape)}")
        return x

    def grid_noise(noise, seed, sample_ids: torch.Tensor,
                   row_ids: torch.Tensor) -> EpsAt:
        """eps (K·B, D) of step t for every (sample, row) of a K × B grid,
        sample-major."""
        k, b = len(sample_ids), len(row_ids)
        if noise is not None:
            noise = torch.as_tensor(noise, device=model.device)
            if tuple(noise.shape) != (n_free, k, b, d):
                raise ValueError(f"noise must be {(n_free, k, b, d)}, got "
                                 f"{tuple(noise.shape)}")
            return lambda t: noise[t].reshape(k * b, d)
        return lambda t: gp_mod.fork_noise(
            seed, sample_ids[:, None], t, row_ids[None, :], d,
            device=model.device).reshape(k * b, d)

    def rollout(p: Prepared, x: torch.Tensor, k: int, fork: np.ndarray,
                eps_at: EpsAt, mean_mode: bool = False
                ) -> Iterator[torch.Tensor]:
        """The free run of k futures of every clip of x (already in the
        compute dtype), as one merged sample-major (k·B) batch; yields
        each step's frames (k·B, H, W, C) in the compute dtype."""
        m = p.model
        with span("dvg.eval.context"):
            hidden_b, skip_b, x_in_b = _context_phase(m, x, n_past)
            hidden = tuple(a.repeat(1, k, 1) for a in hidden_b)
            x_in = x_in_b.repeat(k, 1, 1, 1)
            # frozen skips: the skip halves are computed at batch B and
            # tiled ONCE, so the in-loop add is shape-equal
            skip_pre = None if refresh else [
                p.repeat(k, 1, 1, 1) for p in m.decode_skip_pre(skip_b)]
        for t in range(n_free):
            with span("dvg.eval.encode"):
                h, skips_new = m.encode(x_in, skips=refresh)
            with span("dvg.eval.lstm"):
                latent, hidden = m.predict_latent(hidden, h)
            if mean_mode:
                with span("dvg.eval.gp_draw"):
                    mean, _ = gp_mod.cached_mean_var(p.cache,
                                                     m.to_gp_layout(latent))
                    latent = m.from_gp_layout(mean)
            elif fork[t]:
                with span("dvg.eval.gp_draw"):
                    latent = draw(p, h, eps_at(t), k)
            with span("dvg.eval.decode"):
                x_in = (m.decode(latent, skips_new) if refresh
                        else m.decode_hoisted(latent, skip_pre))
            yield x_in

    def draw(p: Prepared, h: torch.Tensor, eps: torch.Tensor, groups: int
             ) -> torch.Tensor:
        """GP sample of gp(h) for the merged batch h (groups·B, D), eps
        (groups·B, D): per-row marginal, or (full_cov) correlated across
        the B rows of each group."""
        m = p.model
        if not fc:
            return m.from_gp_layout(gp_mod.cached_rsample(
                p.cache, m.to_gp_layout(h), eps.to(h.dtype).transpose(0, 1)))
        b = h.shape[0] // groups
        y = gp_mod.cached_rsample_fullcov(
            p.cache32, h.reshape(groups, b, d).transpose(1, 2)[..., None],
            eps.reshape(groups, b, d).transpose(1, 2))
        return y.transpose(1, 2).reshape(groups * b, d)

    @torch.inference_mode()
    def sampled(x, sample_ids, row_ids, fork: np.ndarray, seed: int, noise,
                device) -> torch.Tensor:
        """(K, n_eval, B, H, W, C) f32: the futures of samples `sample_ids`
        for the clips of x, whose global row ids are `row_ids`."""
        x = clip(x, device, n_past)
        sample_ids = _ids(sample_ids)
        row_ids = _ids(row_ids)
        if len(row_ids) != x.shape[1]:
            raise ValueError(f"{len(row_ids)} row ids for {x.shape[1]} "
                             "clips")
        k, b = len(sample_ids), x.shape[1]
        eps_at = grid_noise(noise, seed, sample_ids, row_ids)
        p = prepare()
        x = x.to(dtype)
        frames = torch.empty((n_free, k * b) + x.shape[2:],
                             dtype=torch.float32, device=x.device)
        for t, x_out in enumerate(rollout(p, x, k, fork, eps_at)):
            frames[t] = x_out
        frames = frames.reshape((n_free, k, b) + x.shape[2:]).transpose(0, 1)
        ctx = x[:n_past].float().expand((k,) + x[:n_past].shape)
        return torch.cat([ctx, frames], dim=1)

    def posterior_core(p: Prepared, x: torch.Tensor) -> torch.Tensor:
        x = x.to(dtype)
        frames = [x_out.float() for x_out in rollout(
            p, x, 1, np.zeros(n_free, bool), None, mean_mode=True)]
        return torch.cat([x[:n_past].float(), torch.stack(frames)], dim=0)

    @torch.inference_mode()
    def posterior(x, device="cuda") -> torch.Tensor:
        """(T, B, H, W, C) f32: the context frames, then n_free frames each
        decoding the GP posterior mean of the LSTM's prediction."""
        x = clip(x, device, n_past)
        return posterior_core(prepare(), x)

    def diverse(x, seed: int = 0, noise=None, device="cuda") -> torch.Tensor:
        b = torch.as_tensor(x).shape[1]
        return sampled(x, torch.arange(s_n), torch.arange(b), fork_15, seed,
                       noise, device)

    def plot_samples(x, seed: int = 0, noise=None, device="cuda"
                     ) -> torch.Tensor:
        b = torch.as_tensor(x).shape[1]
        return sampled(x, torch.arange(PLOT_SAMPLES), torch.arange(b),
                       fork_10, seed, noise, device)

    def diverse_select(x, sample_ids, row_ids, seed: int = 0, noise=None,
                       device="cuda") -> torch.Tensor:
        """Re-roll samples `sample_ids` on the clips x, whose global row ids
        are `row_ids`: the futures `diverse_metrics(seed=seed)` scored."""
        if fc:
            raise ValueError(
                "diverse_select cannot reproduce scored futures under "
                "cfg.full_cov_sampling: the correlated draw spans the whole "
                "batch, so a row subset (or the same rows reordered) changes "
                "the sample. Re-roll the whole batch with "
                "diverse_rollout_with_keys instead.")
        return sampled(x, sample_ids, row_ids, fork_15, seed, noise, device)

    def diverse_rollout_with_keys(x, sample_ids, row_ids=None,
                                  seed: int = 0, noise=None, device="cuda"
                                  ) -> torch.Tensor:
        """Full-batch re-roll of samples `sample_ids`; under
        cfg.full_cov_sampling it reproduces the correlated draws that
        diverse_metrics scored, since it re-rolls the whole batch."""
        if row_ids is None:
            row_ids = torch.arange(torch.as_tensor(x).shape[1])
        return sampled(x, sample_ids, row_ids, fork_15, seed, noise, device)

    @torch.inference_mode()
    def diverse_select_pairs(x_sel, sample_ids, row_ids, seed: int = 0,
                             noise=None, device="cuda") -> torch.Tensor:
        """ONE K-batch rollout replaying K (sample, row) pairs: x_sel
        (T, K, H, W, C) holds in column k the clip of global row
        row_ids[k], which replays sample sample_ids[k]. → (n_eval, K, H, W,
        C) f32. Marginal draws only."""
        if fc:
            raise ValueError(
                "diverse_select_pairs replays per-row MARGINAL draws only; "
                "under cfg.full_cov_sampling the scored draw was correlated "
                "across the whole batch — re-roll with "
                "diverse_rollout_with_keys on the full batch instead.")
        x_sel = clip(x_sel, device, n_past)
        sample_ids, row_ids = _ids(sample_ids), _ids(row_ids)
        k = x_sel.shape[1]
        if not len(sample_ids) == len(row_ids) == k:
            raise ValueError(f"{len(sample_ids)} sample ids and "
                             f"{len(row_ids)} row ids for {k} clips")
        if noise is not None:
            noise = torch.as_tensor(noise, device=model.device)
            if tuple(noise.shape) != (n_free, k, d):
                raise ValueError(f"noise must be {(n_free, k, d)}, got "
                                 f"{tuple(noise.shape)}")
            eps_at = noise.__getitem__
        else:
            def eps_at(t):
                return gp_mod.fork_noise(seed, sample_ids, t, row_ids, d,
                                         device=model.device)
        p = prepare()
        x_sel = x_sel.to(dtype)
        frames = [x_out.float() for x_out in rollout(
            p, x_sel, 1, fork_15, eps_at)]
        return torch.cat([x_sel[:n_past].float(), torch.stack(frames)], dim=0)

    def step_metrics(gt: torch.Tensor) -> Callable[[int, torch.Tensor],
                                                   torch.Tensor]:
        """For gt (n_free, B, H, W, C) f32: (t, frames (S·B, H, W, C) of
        step t) → (3, S, B) ssim, psnr, mse by the route cfg selects."""
        b, img = gt.shape[1], tuple(gt.shape[2:])
        if use_kernel:
            return lambda t, x_out: ssim_psnr_batch_cyclic(
                gt[t], x_out.contiguous()).view(3, s_n, b)
        pre = None if finn else {
            k: v.reshape((n_free, b) + v.shape[1:])
            for k, v in ssim_gt_precompute(gt.flatten(0, 1)).items()}
        f = int(np.prod(img))
        gs = gt.reshape(n_free, b, f)
        g2 = (gs * gs).sum(-1)                               # (n_free, B)

        def metrics(t: int, x_out: torch.Tensor) -> torch.Tensor:
            xs = x_out.float().reshape((s_n, b) + img)
            if finn:
                s_v, q_v = finn_ssim_psnr_batch(gt[t], xs)
            else:
                s_v, q_v = ssim_psnr_batch_pre(
                    {k: v[t] for k, v in pre.items()}, xs)
            xf = xs.reshape(s_n, b, f)
            cross = torch.bmm(xf.transpose(0, 1), gs[t][:, :, None])
            m_v = ((xf * xf).sum(-1) - 2.0 * cross[..., 0].T
                   + g2[t][None]) / f
            return torch.stack([s_v, q_v, m_v])
        return metrics

    def metrics_core(p: Prepared, x: torch.Tensor, seed=0, row_offset=0,
                     sample_offset=0, noise=None) -> Dict[str, torch.Tensor]:
        b = x.shape[1]
        eps_at = grid_noise(noise, seed, sample_offset + torch.arange(s_n),
                            row_offset + torch.arange(b))
        # metrics against the f32 truth
        score = step_metrics(x[n_past:n_eval].float().contiguous())
        x = x.to(dtype)
        scores = []
        for t, x_out in enumerate(rollout(p, x, s_n, fork_15, eps_at)):
            with span("dvg.eval.score"):
                scores.append(score(t, x_out))
        out = torch.stack(scores, dim=2)
        return {"ssim": out[0], "psnr": out[1], "mse": out[2]}

    @torch.inference_mode()
    def diverse_metrics(x, seed: int = 0, noise=None, device="cuda",
                        row_offset: int = 0, sample_offset: int = 0
                        ) -> Dict[str, torch.Tensor]:
        """All S futures scored in the loop; frames never accumulate.
        `row_offset` and `sample_offset` are the global ids of x's first
        row and of the first of the S futures, so a block of a larger
        (samples × rows) grid draws what the whole grid drew for the same
        ids (`parallel.shard_diverse_metrics`)."""
        x = clip(x, device, n_eval)
        return metrics_core(prepare(), x, seed, row_offset, sample_offset,
                            noise)

    def trigger_core(p: Prepared, x: torch.Tensor, seed=0, noise=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if n_eval < TRIGGER_WARMUP:
            raise ValueError(
                f"gp_trigger needs n_eval >= {TRIGGER_WARMUP} (the fixed "
                f"{TRIGGER_WARMUP}-step free-run warmup that seeds the "
                f"rolling threshold window) but cfg.n_eval={n_eval}")
        m, b = p.model, x.shape[1]
        if noise is None:
            # every decision step's draw in one call: one hash in the
            # graph instead of one per step, the same eps
            steps = torch.arange(TRIGGER_WARMUP, n_eval, device=x.device)
            noise = gp_mod.fork_noise(seed, 0, steps[:, None],
                                      torch.arange(b)[None], d,
                                      device=x.device)

        x = x.to(dtype)

        def var_norm(h: torch.Tensor) -> torch.Tensor:
            v = gp_mod.cached_variance(p.cache, m.to_gp_layout(h))  # (D, B)
            return torch.linalg.vector_norm(v.float(), dim=0)      # (B,)

        hidden = m.lstm_hidden_init(b, dtype=dtype)
        x_in = x[0]
        frames, window = [], []
        skip = None
        for i in range(TRIGGER_WARMUP):
            h, skips_i = m.encode(x_in)
            if i < TRIGGER_SKIP_FRAMES:        # the skip updates BEFORE decode
                skip = skips_i
            window.append(var_norm(h))
            h_pred, hidden = m.predict_latent(hidden, h)
            x_in = m.decode(h_pred, skip)
            frames.append(x_in.float())
        warmup_values = window = torch.stack(window)
        skip_pre = m.decode_skip_pre(skip)

        triggers, values, thresholds = [], [], []
        for i in range(TRIGGER_WARMUP, n_eval):
            h, _ = m.encode(x_in, skips=False)
            value = var_norm(h)
            window = torch.cat([window[1:], value[None]])
            thresh = (window.mean(0)
                      + cfg.trigger_sigma * window.std(0, correction=0)
                      - cfg.trigger_margin)
            h_pred, hidden_new = m.predict_latent(hidden, h)
            sample = draw(p, h, noise[i - TRIGGER_WARMUP], 1)
            trig = value > thresh                                   # (B,)
            latent = torch.where(trig[:, None], sample, h_pred)
            # triggered rows skip the LSTM step: their hidden stays stale
            hidden = tuple(torch.where(trig[None, :, None], old, new)
                           for old, new in zip(hidden, hidden_new))
            x_in = m.decode_hoisted(latent, skip_pre)
            frames.append(x_in.float())
            triggers.append(trig)
            values.append(value)
            thresholds.append(thresh)

        def stacked(steps: List[torch.Tensor], dtype) -> torch.Tensor:
            """(n_eval − 12, B); empty at n_eval 12."""
            return torch.stack(steps) if steps else torch.empty(
                (0, b), dtype=dtype, device=x.device)
        return torch.stack(frames), {
            "triggers": stacked(triggers, torch.bool),
            "values": stacked(values, torch.float32),
            "thresholds": stacked(thresholds, torch.float32),
            "warmup_values": warmup_values}

    @torch.inference_mode()
    def gp_trigger(x, seed: int = 0, noise=None, device="cuda"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The adaptive path: free-run n_eval frames from x[0] with no
        teacher forcing. The first 12 steps decode the LSTM's prediction
        with the skips of the first 5 encodes and fill a per-row window of
        ‖var‖ of gp(h); after it, a row forks to a GP sample whenever its
        ‖var‖ exceeds mean + trigger_sigma·std − trigger_margin of the
        rolling 12-value window, and its LSTM hidden stays stale on that
        step. The skips stay frozen after the warm-up. The diagnostics
        carry each step's threshold beside its value (the JAX package
        returns the values only)."""
        x = clip(x, device, 1)
        b = x.shape[1]
        if noise is not None:
            noise = torch.as_tensor(noise, device=model.device)
            want = (n_eval - TRIGGER_WARMUP, b, d)
            if tuple(noise.shape) != want:
                raise ValueError(f"noise must be {want}, got "
                                 f"{tuple(noise.shape)}")
        return trigger_core(prepare(), x, seed, noise)

    return RolloutFns(posterior=posterior, diverse=diverse,
                      diverse_metrics=diverse_metrics,
                      diverse_select=diverse_select,
                      diverse_select_pairs=diverse_select_pairs,
                      diverse_rollout_with_keys=diverse_rollout_with_keys,
                      plot_samples=plot_samples, gp_trigger=gp_trigger,
                      nsample=s_n, prepare=prepare,
                      cores=Cores(posterior_core, metrics_core,
                                  trigger_core))


def best_of_n(metric_bst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """metric (B, S, T) → (best sample index per row by mean over T, that
    mean). Ties go to the LAST maximal sample."""
    mean_bs = metric_bst.mean(dim=-1)
    s = mean_bs.shape[-1]
    idx = (s - 1) - torch.argmax(mean_bs.flip(-1), dim=-1)
    return idx, torch.gather(mean_bs, 1, idx[:, None])[:, 0]
