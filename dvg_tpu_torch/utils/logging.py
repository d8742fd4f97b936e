"""Structured metric logging: one JSON object per line in
<log_dir>/metrics.jsonl, echoed to the console, and eval arrays saved as
.npz (counterpart of `dvg_tpu/utils/logging.py`, the same record schema).
Only the coordinator (`parallel.is_coordinator`: rank 0, or a run without a
process group) writes; every rank echoes to its own console."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from dvg_tpu_torch.parallel.mesh import is_coordinator


class MetricLogger:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 echo: bool = True):
        self.log_dir = log_dir
        self.writer = is_coordinator()
        if self.writer:
            os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self.echo = echo
        self._t0 = time.time()

    _RESERVED = ("kind", "step", "wall_s")

    def log(self, step: int, metrics: Dict, kind: str = "train") -> None:
        """Append {"kind", "step", "wall_s", **metrics}: floats where a
        value converts, small arrays as lists, larger ones as a summary
        string; a metric named like a bookkeeping field gets "_metric"
        appended."""
        rec = {"kind": kind, "step": int(step),
               "wall_s": round(time.time() - self._t0, 3)}
        keys = []
        for k, v in metrics.items():
            key = k if k not in self._RESERVED else k + "_metric"
            keys.append(key)
            try:
                rec[key] = float(v)
            except (TypeError, ValueError, RuntimeError):
                try:
                    a = np.asarray(v)
                    rec[key] = (a.tolist() if a.size <= 64 else
                                f"<array shape={a.shape} dtype={a.dtype}>")
                except Exception:
                    rec[key] = str(v)
        if self.writer:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")
        if self.echo:
            body = " ".join(f"{k}={rec[k]:.5g}" if isinstance(rec[k], float)
                            else f"{k}={rec[k]}" for k in keys)
            print(f"[{kind} {step}] {body}", flush=True)

    def save_arrays(self, name: str, **arrays) -> str:
        """Save arrays (e.g. the (B, S, T) SSIM/PSNR grids) as
        <log_dir>/<name>.npz on the coordinator; returns the path."""
        path = os.path.join(self.log_dir, f"{name}.npz")
        if not self.writer:
            return path
        np.savez_compressed(path, **{k: np.asarray(v)
                                     for k, v in arrays.items()})
        return path
