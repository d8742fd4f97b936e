"""The readings the limits of `correct` are set from, at a cell's own size.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 \
        [--control 3] [--f32] [--faults] [--out FILE]

For each seed, on the card: the program set up as a run sets it up, the
window units its check follows (the driver's CHECK_UNITS), then the
compared numbers of the plain reference against the
program (`program`); for the first `--control` seeds also against the
control, the reference computed in fp8 in the program's place
(`control`). `--f32` adds, on the first seed, the program in f32 with
TF32 off (`program_f32`: how close the reference follows the program's
arithmetic). `--faults` adds, on the first three seeds, the faults a
training step can have, planted in the program: a step that sees half
its batch (`half_batch`) and a step that hands back the previous step's
loss (`stale_loss`). A step that leaves the state unchanged
(`unchanged`, planted by the tests) reads 1 by `change_gap`'s measure and
needs no run on the card.

Each reading is one JSON line on standard output (and in `--out`). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
from typing import Dict, Iterator, Optional

from benchmark import manifest
from benchmark.reference.quant import FP8Ops
from benchmark.run import ROOT, _fix_caches


@contextlib.contextmanager
def planted(fault: Optional[str]) -> Iterator[None]:
    """The program's train step with `fault` planted in it."""
    if fault is None:
        yield
        return
    from dvg_tpu_torch.train import step as step_mod
    original = step_mod.make_train_step

    def broken(cfg, group=None):
        step_fn = original(cfg, group)
        previous = {}

        def faulty(state, x):
            if fault == "half_batch":
                return step_fn(state, x[:, : x.shape[1] // 2])
            if fault == "unchanged":
                kept = {k: v.clone()
                        for k, v in state.model.state_dict().items()}
                state, metrics = step_fn(state, x)
                state.model.load_state_dict(kept)
                return state, metrics
            state, metrics = step_fn(state, x)
            if fault == "stale_loss":
                loss = metrics["loss"]
                metrics = dict(metrics, loss=previous.get("loss", loss))
                previous["loss"] = loss
            return state, metrics
        return faulty
    step_mod.make_train_step = broken
    try:
        yield
    finally:
        step_mod.make_train_step = original


def readings(cell, seed: int, device: str, control: bool,
             overrides: Optional[Dict] = None, fault: Optional[str] = None
             ) -> Dict[str, Dict[str, float]]:
    mod = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    with planted(fault):
        drv = mod.Driver(cell, seed, device, overrides=overrides)
    for _ in range(drv.CHECK_UNITS):
        drv.unit()
    drv.sync()
    drv.release()
    if cell.traffic["driver"] == "eval":
        calls = drv.checked_calls()[-1:]
        out = {"program": drv.readings(calls=calls)}
        if control:
            out["control"] = drv.readings(FP8Ops(), calls=calls)
    else:
        out = {"program": drv.readings()}
        if control:
            out["control"] = drv.readings(FP8Ops())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    _fix_caches()
    import torch
    cell = manifest.Cell(manifest.load(ROOT), args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    # readings need no timing: one warm-up call (cuDNN's autotuning)
    quick = {"warmup_calls": 1} if cell.traffic["driver"] == "eval" else {}
    for k, seed in enumerate(seeds):
        for kind, r in readings(cell, seed, "cuda", k < args.control,
                                quick).items():
            emit({"cell": cell.name, "seed": seed, "kind": kind, **r})
        if args.f32 and k == 0:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            r = readings(cell, seed, "cuda", False,
                         overrides=dict(quick, dtype="float32"))["program"]
            emit({"cell": cell.name, "seed": seed, "kind": "program_f32",
                  **r})
        if args.faults and k < 3:
            for fault in ("half_batch", "stale_loss"):
                r = readings(cell, seed, "cuda", False, quick,
                             fault=fault)["program"]
                emit({"cell": cell.name, "seed": seed, "kind": fault, **r})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
