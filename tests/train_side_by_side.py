"""Both packages' training steps side by side on the CPU, at the recipe's
widths (DCGAN-64, C 1, g_dim 90, rnn 256×2, 40 inducing points, n_past 5,
n_future 10), from one seeded init and on one stream of procedural
Moving-MNIST batches:

  * `dvg_tpu`'s jitted `make_train_step_fn` (run "jax");
  * the port's `make_train_step` from the same weights (run "port");
  * the port again from those weights with every one moved by one f32 ulp
    (run "ulp"): how far rounding alone carries a trajectory.

Every `--every` steps it writes, per optimizer group, the relative
distance ‖a − b‖ / ‖b‖ of port from jax and of ulp from port, and each
run's step losses. After the last step the three models run the same eval
(the port's `diverse_metrics` in f32 with one seed for all three, and
`posterior`) on the soak's first test batch, and it writes their mean
SSIM per free step. If the port trains as `dvg_tpu` does, port-vs-jax
stays of the order of ulp-vs-port and the three profiles agree as far as
ulp-vs-port do.

    python tests/train_side_by_side.py --steps 200 --batch 2 \\
        --dtype bfloat16 --out side_by_side.jsonl

`--bias_grads` trains nothing: it prints, for every bias, how far each
package's bf16 joint-pass gradient lies from the port's f32 gradient, at
the seeded init, on the first training batch, and the port's again under
experiments/tpu_precision.py's `xla_bias_sum()` with its distance from
dvg_tpu's.

The GP schedule's epoch is a sixth of the run, so that both milestones
(epochs 3 and 5) fall inside it. XLA:CPU takes
~5.6 s per step at B 2 on an 8-core host, the port ~0.5 s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dvg_tpu.config import DVGConfig as JaxConfig  # noqa: E402
from dvg_tpu.models.dvg import DVGModel as JaxModel  # noqa: E402
from dvg_tpu.train import step as JS  # noqa: E402
from dvg_tpu.train.optim import make_optimizers as j_make_optimizers  # noqa
from dvg_tpu.train.optim import split_params as j_split  # noqa: E402
from dvg_tpu_torch.config import DVGConfig  # noqa: E402
from dvg_tpu_torch.convert import params_from_jax, params_to_jax  # noqa
from dvg_tpu_torch.data import Loader, load_dataset  # noqa: E402
from dvg_tpu_torch.generate.rollout import make_rollout_fns  # noqa: E402
from dvg_tpu_torch.models.dvg import DVGModel  # noqa: E402
from dvg_tpu_torch.ops.ssim import ssim_psnr_images_plain  # noqa: E402
from dvg_tpu_torch.train import make_train_step, train_state  # noqa: E402
from dvg_tpu_torch.train import step as PS  # noqa: E402

RECIPE = dict(dataset="smmnist", channels=1, image_width=64, n_past=5,
              n_future=10, n_eval=15, g_dim=90, rnn_size=256, model="dcgan",
              data_root="")
GROUPS = ("encoder", "decoder", "frame_predictor", "gp")
EVAL_N, EVAL_ROWS, EVAL_S = 30, 8, 4


def ulp_perturbed(model: DVGModel, seed: int) -> DVGModel:
    """A copy of `model` with every parameter moved by one f32 ulp, each
    element's sign drawn from `seed`."""
    out = DVGModel(model.cfg, device="cpu")
    out.load_state_dict(model.state_dict())
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in out.parameters():
            sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
            p.mul_(1 + sign.to(p.dtype) * 2.0 ** -23)
    return out


def group_dist(a: dict, b: dict) -> dict:
    """Per group (the GP group holds gp.* and likelihood.*), ‖a − b‖/‖b‖
    over its parameters (running statistics excluded)."""
    out = {}
    for g in GROUPS:
        keys = [k for k in b if (k.startswith(g) or (
            g == "gp" and k.startswith("likelihood")))
            and "running" not in k and "num_batches" not in k]
        num = sum(float(((a[k].double() - b[k].double()) ** 2).sum())
                  for k in keys)
        den = sum(float((b[k].double() ** 2).sum()) for k in keys)
        out[g] = (num / den) ** 0.5
    return out


def eval_profile(model: DVGModel, cfg: DVGConfig, x, seed: int) -> dict:
    """Mean SSIM per free step of diverse_metrics (f32, GP noise from
    `seed`) and of posterior, on x (T, B, H, W, C)."""
    ecfg = cfg.replace(dtype="float32", nsample=EVAL_S,
                       batch_size=x.shape[1], n_eval=x.shape[0],
                       n_future=x.shape[0] - cfg.n_past)
    fns = make_rollout_fns(model.float(), ecfg)
    dm = fns.diverse_metrics(x, seed=seed, device="cpu")["ssim"]
    post = fns.posterior(x, device="cpu")
    xt = torch.as_tensor(x)
    ps = [ssim_psnr_images_plain(xt[t].contiguous(),
                                 post[t].contiguous())[0].mean().item()
          for t in range(cfg.n_past, x.shape[0])]
    return dict(diverse=dm.mean(dim=(0, 2)).tolist(), posterior=ps)


def first_train_batch(cfg: DVGConfig, batch: int, seed: int) -> np.ndarray:
    loader = Loader(load_dataset(cfg, seq_len=cfg.n_eval, split="train"),
                    batch, seed=seed, num_threads=1, device="cpu")
    try:
        return np.asarray(loader.next_batch(0)).astype(np.float32)
    finally:
        loader.stop()


def port_pass(state_dict: dict, cfg: DVGConfig, x: np.ndarray) -> tuple:
    """The port's joint pass at `state_dict` on x → (its loss and metrics,
    its gradients by name)."""
    model = DVGModel(cfg, device="cpu")
    model.load_state_dict(state_dict)
    model = train_state(model, cfg).model
    plan = PS.make_plan(cfg, x.shape[0], torch.device("cpu"))
    loss, metrics, *_ = PS.joint_loss(model, torch.from_numpy(x), cfg, plan)
    loss.backward()
    return ({"loss": loss.detach(),
             **{k: v.detach() for k, v in metrics.items()}},
            {k: p.grad for k, p in model.named_parameters()})


def jax_grads(state_dict: dict, cfg: DVGConfig, x: np.ndarray) -> dict:
    """dvg_tpu's joint-pass gradients at `state_dict` on x, by the port's
    names."""
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    params, stats = params_to_jax(state_dict, cfg)
    jmodel = JaxModel(jcfg)
    _, g = jax.jit(lambda p, s, xx: jax.value_and_grad(
        JS.joint_loss, has_aux=True)(p, s, xx, jmodel, jcfg))(
        *(jax.tree.map(jnp.asarray, t) for t in (params, stats)),
        jnp.asarray(x))
    return params_from_jax(jax.tree.map(np.asarray, g), stats, cfg)


def bias_grads(state_dict: dict, batch: int, seed: int) -> str:
    """Per bias: ‖g − g32‖/‖g32‖ of each package's bf16 joint-pass
    gradient, g32 the port's f32 one, on the first training batch; then
    the port's again under experiments/tpu_precision.py's
    `xla_bias_sum()`, and that gradient's distance ‖g − g_jax‖/‖g_jax‖
    from dvg_tpu's bf16 one."""
    cfgs = {dt: DVGConfig(**dict(RECIPE, batch_size=batch, dtype=dt,
                                 seed=seed))
            for dt in ("float32", "bfloat16")}
    x = first_train_batch(cfgs["float32"], batch, seed)
    want = port_pass(state_dict, cfgs["float32"], x)[1]
    got = {"dvg_tpu": jax_grads(state_dict, cfgs["bfloat16"], x),
           "port": port_pass(state_dict, cfgs["bfloat16"], x)[1]}
    tpu_precision().xla_bias_sum()
    emu = got["port, xla_bias_sum"] = port_pass(state_dict,
                                                cfgs["bfloat16"], x)[1]

    def dist(a, b):
        return ((a.double() - b.double()).norm()
                / max(b.double().norm().item(), 1e-30)).item()

    lines = []
    for k, w in want.items():
        if not k.endswith(("bias", "bias_ih", "bias_hh")):
            continue
        lines.append(f"{k:36s} |g32| {w.double().norm().item():.3e}  bf16 "
                     "off f32: " + "  ".join(f"{n} {dist(g[k], w):.3g}"
                                             for n, g in got.items())
                     + "  | port, xla_bias_sum off dvg_tpu "
                     f"{dist(emu[k], got['dvg_tpu'][k]):.3g}")
    return "\n".join(lines)


def tpu_precision():
    """experiments/tpu_precision.py as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "experiments", "tpu_precision.py")
    spec = importlib.util.spec_from_file_location("tpu_precision", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default="side_by_side.jsonl")
    p.add_argument("--jax_ulp", action="store_true",
                   help="also run dvg_tpu from the one-ulp-moved init "
                        "(run \"jax_ulp\")")
    p.add_argument("--bias_grads", action="store_true",
                   help="print the bias gradients' bf16 error and exit")
    p.add_argument("--save", default="",
                   help="also torch.save the three models' final state "
                        "dicts and config here")
    a = p.parse_args(argv)
    geom = dict(RECIPE, batch_size=a.batch, dtype=a.dtype, seed=a.seed,
                epoch_size=max(1, a.steps // 6))
    cfg, jcfg = DVGConfig(**geom), JaxConfig(**geom)
    if a.bias_grads:
        print(bias_grads(DVGModel(cfg, seed=a.seed, device="cpu")
                         .state_dict(), a.batch, a.seed))
        return 0
    params, stats = params_to_jax(
        DVGModel(cfg, seed=a.seed, device="cpu").state_dict(), cfg)
    jmodel, opts = JaxModel(jcfg), j_make_optimizers(jcfg)
    jp, js = (jax.tree.map(jnp.asarray, t) for t in (params, stats))
    groups = j_split(jp)
    jstate = JS.TrainState(jp, js, {n: getattr(opts, n).init(groups[n])
                                    for n in groups},
                           jnp.zeros((), jnp.int32))
    jstep = jax.jit(JS.make_train_step_fn(jmodel, jcfg, opts))
    port = DVGModel(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, stats, cfg))
    runs = {"port": train_state(port, cfg),
            "ulp": train_state(ulp_perturbed(port, seed=9), cfg)}
    jruns = {"jax": jstate}
    if a.jax_ulp:
        up, us = params_to_jax(runs["ulp"].model.state_dict(), cfg)
        up, us = (jax.tree.map(jnp.asarray, t) for t in (up, us))
        jruns["jax_ulp"] = JS.TrainState(
            up, us, {n: getattr(opts, n).init(g) for n, g in
                     j_split(up).items()}, jnp.zeros((), jnp.int32))
    pstep = make_train_step(cfg)
    loader = Loader(load_dataset(cfg, seq_len=cfg.n_eval, split="train"),
                    a.batch, seed=a.seed, num_threads=1, device="cpu")
    out = open(a.out, "w")

    def write(rec):
        out.write(json.dumps(rec) + "\n")
        out.flush()
        print(json.dumps(rec), flush=True)

    def jax_sd(name):
        st = jruns[name]
        return params_from_jax(jax.tree.map(np.asarray, st.params),
                               jax.tree.map(np.asarray, st.stats), cfg)

    t0 = time.perf_counter()
    try:
        for k in range(a.steps):
            x = np.asarray(loader.next_batch(k)).astype(np.float32)
            losses = {}
            for name in jruns:
                jruns[name], jm = jstep(jruns[name], jnp.asarray(x))
                losses[name] = {n: float(v) for n, v in jm.items()}
            for name, st in runs.items():
                _, m = pstep(st, torch.from_numpy(x))
                losses[name] = {n: float(v) for n, v in m.items()}
            rec = {"step": k, "losses": losses,
                   "s": round(time.perf_counter() - t0, 1)}
            if (k + 1) % a.every == 0 or k + 1 == a.steps:
                sd = {n: st.model.state_dict() for n, st in runs.items()}
                rec["port_vs_jax"] = group_dist(sd["port"], jax_sd("jax"))
                rec["ulp_vs_port"] = group_dist(sd["ulp"], sd["port"])
            write(rec)
    finally:
        loader.stop()
    test = Loader(load_dataset(cfg, seq_len=EVAL_N, split="test"),
                  EVAL_ROWS, shuffle=False, seed=a.seed, num_threads=1,
                  device="cpu")
    try:
        x = np.asarray(test.next_batch(0)).astype(np.float32)
    finally:
        test.stop()
    models = {}
    for name in jruns:
        models[name] = DVGModel(cfg, device="cpu")
        models[name].load_state_dict(jax_sd(name))
    models.update({n: st.model for n, st in runs.items()})
    if a.save:
        torch.save({"cfg": cfg.to_dict(), **{
            n: {k: v.cpu() for k, v in m.state_dict().items()}
            for n, m in models.items()}}, a.save)
    write({"eval": {n: eval_profile(m, cfg, x, a.seed)
                    for n, m in models.items()},
           "n_eval": EVAL_N, "rows": EVAL_ROWS, "S": EVAL_S})
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
