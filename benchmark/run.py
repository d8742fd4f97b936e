"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell comes from `BENCHMARK.json`; its configuration, traffic mix,
driver, per-layer readers and limits are files under `benchmark/` found by
name. A run makes its weights and clips from `--seed`, sets up and warms
the program (timed as `setup_s`, from the process's start to the first
timed unit), runs units back to back for `--seconds`, and with `--trace 1`
profiles `trace_units` more. Then it reads the card's peak memory, frees
the program's state, runs the plain reference and compares, and prints one
JSON object as its last line of standard output:

    {"correct", "attempted", "failed", "metrics", "device"
     [, "breakdown"], "checks"}

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer ones. Each compared number and its limit close standard error
and the result's `checks`. Without a CUDA card, with fewer cards than the
cell asks for, or with `jax`, `jaxlib`, `flax` or `dvg_tpu` among the
loaded modules once the window has closed, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "dvg_tpu")


def _fix_caches() -> None:
    """Compile caches at fixed paths inside the checkout, so that only a
    cell's first run there compiles."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared as
    whole names (`dvg_tpu_torch` is not `dvg_tpu`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def limits_of(cell_name: str) -> Dict[str, float]:
    path = HERE / "limits" / f"{cell_name}.json"
    if not path.exists():
        return {}
    return {k: v["limit"] for k, v in json.loads(path.read_text()).items()}


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             overrides: Optional[Dict] = None) -> Tuple[Dict, int]:
    """(the result object, exit code) of one run of `cell`."""
    import torch
    from benchmark.metrics import reader
    from benchmark.yardstick import device as dev_info
    from benchmark.yardstick import trace as tr_mod

    cuda = torch.device(device).type == "cuda"
    power = dev_info.power_limit() if cuda else "cpu"
    driver_mod = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    drv = driver_mod.Driver(cell, seed, device, count_flops=trace,
                            overrides=overrides)
    setup_s = dev_info.process_age_s()
    start = time.perf_counter()
    deadline = start + seconds
    units = 0
    while True:
        drv.unit()
        units += 1
        if units >= drv.CHECK_UNITS and time.perf_counter() >= deadline:
            break
    drv.sync()
    end = time.perf_counter()
    found = forbidden_modules()
    if found:
        return {"forbidden": found}, 3

    metrics: Dict[str, Dict] = {}
    extra: Dict = {}
    if trace:
        n = cell.traffic["trace_units"]
        tr = tr_mod.capture(drv.trace_unit, n)
        ctx = drv.trace_context()
        for m in cell.per_layer:
            value = reader(m["name"])(tr, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = tr_mod.breakdown(
            tr, tr_mod.GROUP_TABLES[drv.groups])
        busy = tr_mod.busy_s(tr)
    else:
        e2e = drv.measure(start, end)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if cuda:
        device_rec = dev_info.device_record(cell.chips, power)
        if trace:
            device_rec.update(busy_s=busy, window_s=tr.window_s)
    else:
        device_rec = {"platform": "cpu", "kind": "cpu", "count": 1,
                      "memory_peak_bytes": 0}
    failed = drv.failures(units)
    drv.release()
    readings = drv.readings()
    limits = limits_of(cell.name)
    checks = {k: [readings[k], lim] for k, lim in limits.items()}
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())
    found = forbidden_modules()
    if found:
        return {"forbidden": found}, 3
    result = {"correct": correct, "attempted": units, "failed": failed,
              "metrics": metrics, "device": device_rec, **extra,
              "checks": checks}
    return result, 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _fix_caches()
    from benchmark import manifest
    from benchmark.yardstick.device import require_cards
    cell = manifest.Cell(manifest.load(ROOT), args.workload, ROOT)
    require_cards(cell.chips)
    result, code = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda")
    if code:
        print(f"loaded modules forbidden in a run: {result['forbidden']}",
              file=sys.stderr)
        return code
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    if not result["checks"]:
        print(f"no limits for {cell.name}: correct is false",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
