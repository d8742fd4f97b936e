"""Per-layer metric readers, one file per metric name: `<name>.py` defines
`read(trace, ctx)`, which takes the number from the traced window
(`yardstick.trace.Trace`) and the driver's context, and returns None where
it finds nothing to read. It never returns 0 for a share of a roofline or
of a peak."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent


def reader(name: str, directory: Path = HERE) -> Callable:
    """`metrics/<name>.py`'s `read`."""
    path = Path(directory) / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r} "
                                f"({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
