"""The card a run measured on, and the host-clock helpers.

A measurement path that finds no card fails: nothing here falls back to
the CPU. Every result names `torch.cuda.get_device_name(0)`, the number of
cards used, and the power limit `nvidia-smi` reads."""

from __future__ import annotations

import os
import subprocess
import time
from typing import Dict


def require_cards(n: int) -> None:
    """Raise unless torch sees at least n CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell asks for {n} cards; torch sees "
                         f"{torch.cuda.device_count()}")


def power_limit() -> str:
    """`nvidia-smi`'s name and power limit of card 0, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi gave nothing (rc {out.returncode})"


def device_record(count: int, power: str) -> Dict:
    import torch
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak),
            "power_limit": power}


def process_age_s() -> float:
    """Seconds since this process started, from /proc (Linux); the
    interpreter's own start-up is inside it."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter()
