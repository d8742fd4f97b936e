"""`BENCHMARK.json`: loading, validation, and what one cell runs.

The manifest names every configuration, traffic mix and metric; this module
finds the files behind each name, so a later cell, mix or per-layer metric is
new files plus new entries, never an edit here:

  * a configuration `<name>` is `configs/<name>.json` (its `file` entry);
  * a traffic mix `<name>` is `traffic/<name>.json`, which names its driver
    (`drivers/<driver>.py`);
  * a per-layer metric `<name>` is read by `metrics/<name>.py`.

`load(root)` validates the manifest against the benchmark's contract and
raises `ManifestError` on the first breach.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}
# a width, which `reduced` may never name
WIDTH = re.compile(r"(_dim$|_rank$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per|rnn_size|"
                   r"image_width|channels|num_inducing)", re.I)
BOUND_MAX = 0.25
BOUND_MIN = 0.01
MAX_BYTES = 64 * 1024


class ManifestError(ValueError):
    pass


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ManifestError(what)


def _text(value: Any, what: str, limit: int = 200) -> None:
    _need(isinstance(value, str) and 1 <= len(value) <= limit
          and "\n" not in value and "\t" not in value,
          f"{what} must be 1-{limit} characters on one line, no tab: "
          f"{value!r}")


def _name(value: Any, what: str) -> None:
    _need(isinstance(value, str) and bool(NAME.match(value)),
          f"{what} {value!r} is not a name (letters, digits, _ . -, at most "
          "64, not starting with . or -)")


def _keys(entry: Dict, allowed: set, what: str, extra=frozenset()) -> None:
    _need(isinstance(entry, dict), f"{what} must be an object")
    missing = allowed - set(entry)
    unknown = set(entry) - allowed - set(extra)
    _need(not missing, f"{what} lacks {sorted(missing)}")
    _need(not unknown, f"{what} has unknown keys {sorted(unknown)}")


def _under(path: str, paths: List[str]) -> bool:
    return any(path == p or path.startswith(p.rstrip("/") + "/")
               for p in paths)


def validate(m: Dict[str, Any], root: Path = ROOT) -> None:
    """Raise ManifestError unless `m` keeps the contract."""
    _keys(m, TOP_KEYS, "BENCHMARK.json")
    paths = m["paths"]
    _need(isinstance(paths, list) and 1 <= len(paths) <= 16,
          "paths must list 1-16 directories")
    for p in paths:
        _need(isinstance(p, str) and bool(PATH.match(p))
              and not p.startswith("/") and ".." not in p.split("/"),
              f"path {p!r} is not a relative path inside the repo")
    cmd = m["command"]
    _need(isinstance(cmd, list) and 1 <= len(cmd) <= 32,
          "command must be a list of 1-32 strings")
    for word in cmd:
        _text(word, "a word of command")
        _need(not word.startswith("/") and ".." not in word.split("/"),
              f"command word {word!r} leaves the repo")
    rs = m["run_seconds"]
    _need(isinstance(rs, int) and not isinstance(rs, bool) and 1 <= rs <= 51,
          "run_seconds must be a whole number 1-51")

    configs = m["configs"]
    _need(isinstance(configs, list) and 1 <= len(configs) <= 24,
          "configs must hold 1-24 entries")
    files = set()
    for c in configs:
        _keys(c, CONFIG_KEYS, "a config")
        _name(c["name"], "config name")
        _text(c["source"], "config source")
        _text(c["why"], "config why")
        _need(_under(c["file"], paths), f"config file {c['file']} is not "
              "under paths")
        _need(c["file"] not in files, f"config file {c['file']} is shared")
        files.add(c["file"])
        _need(isinstance(c["reduced"], list) and len(c["reduced"]) <= 16,
              "reduced must list at most 16 keys")
        for k in c["reduced"]:
            _name(k, "a reduced key")
            _need(not WIDTH.search(k), f"reduced names a width: {k}")
    _unique([c["name"] for c in configs], "config")

    cells = m["workloads"]
    _need(isinstance(cells, list) and 1 <= len(cells) <= 24,
          "workloads must hold 1-24 cells")
    config_names = {c["name"] for c in configs}
    pairs = set()
    for w in cells:
        _keys(w, WORKLOAD_KEYS, "a workload")
        for k in ("name", "config", "traffic"):
            _name(w[k], f"workload {k}")
        _text(w["why"], "workload why")
        _need(w["config"] in config_names, f"cell {w['name']} names an "
              f"unknown config {w['config']}")
        _need(w["chips"] in (1, 4), f"cell {w['name']}: chips must be 1 or 4")
        _need((w["config"], w["traffic"]) not in pairs,
              f"config and traffic of {w['name']} appear twice")
        pairs.add((w["config"], w["traffic"]))
    _unique([w["name"] for w in cells], "workload")
    four = sum(w["chips"] == 4 for w in cells)
    _need(four <= max(1, len(cells) // 4),
          f"{four} cells ask for 4 chips; at most 25% (rounded down), or one")
    used = {w["config"] for w in cells}
    _need(config_names <= used, f"configs used by no cell: "
          f"{sorted(config_names - used)}")

    cell_names = {w["name"] for w in cells}
    e2e = m["end_to_end"]
    _need(isinstance(e2e, list) and 1 <= len(e2e) <= 16,
          "end_to_end must hold 1-16 metrics")
    layers = m["per_layer"]
    _need(isinstance(layers, list) and 1 <= len(layers) <= 128,
          "per_layer must hold 1-128 metrics")
    for e in e2e:
        _keys(e, E2E_KEYS, "an end-to-end metric", extra={"workloads"})
        _metric_common(e, cell_names)
        _need(e["source"] in E2E_SOURCES, f"{e['name']}: an end-to-end "
              "metric's source is host_clock or device_trace")
        b = e["bound"]
        _need(isinstance(b, (int, float)) and not isinstance(b, bool)
              and math.isfinite(b) and BOUND_MIN <= b <= BOUND_MAX,
              f"{e['name']}: bound {b!r} outside [{BOUND_MIN}, {BOUND_MAX}]")
    _need(any(e["name"] == "setup_s" for e in e2e), "setup_s is missing")
    e2e_cells = {e["name"]: set(e.get("workloads", cell_names)) for e in e2e}
    for p in layers:
        _keys(p, LAYER_KEYS, "a per-layer metric", extra={"workloads"})
        _metric_common(p, cell_names)
        _text(p["layer"], f"{p['name']}: layer")
        _need(p["moves"] in e2e_cells, f"{p['name']} moves an unknown "
              f"metric {p['moves']}")
        mine = set(p.get("workloads", e2e_cells[p["moves"]]))
        _need(mine <= e2e_cells[p["moves"]], f"{p['name']}: cells "
              f"{sorted(mine - e2e_cells[p['moves']])} do not report "
              f"{p['moves']}")
    _unique([x["name"] for x in e2e + layers], "metric")
    for w in cells:
        mine = [e for e in e2e if w["name"] in e2e_cells[e["name"]]]
        _need(any(e["name"] == "setup_s" for e in mine) and len(mine) >= 2,
              f"cell {w['name']} reports setup_s and no other end-to-end "
              "metric")
        _need(any(w["name"] in p.get("workloads", e2e_cells[p["moves"]])
                  for p in layers), f"cell {w['name']} has no per-layer "
              "metric")
    _files(m, Path(root))


def _files(m: Dict[str, Any], root: Path) -> None:
    """Every file the manifest's names lead to exists."""
    bench = root / HERE.name
    for c in m["configs"]:
        _need((root / c["file"]).is_file(), f"no config file {c['file']}")
    for w in m["workloads"]:
        path = bench / "traffic" / f"{w['traffic']}.json"
        _need(path.is_file(), f"no traffic file {path}")
        driver = json.loads(path.read_text()).get("driver", "")
        _need((bench / "drivers" / f"{driver}.py").is_file(),
              f"traffic {w['traffic']} names no driver file ({driver!r})")
    for p in m["per_layer"]:
        _need((bench / "metrics" / f"{p['name']}.py").is_file(),
              f"per-layer metric {p['name']} has no reader")


def _metric_common(e: Dict, cell_names: set) -> None:
    _name(e["name"], "metric name")
    _need(isinstance(e["unit"], str) and bool(UNIT.match(e["unit"])),
          f"{e['name']}: unit {e['unit']!r} is not 1-16 of letters, digits "
          "and _ / % . -")
    _need(e["better"] in ("lower", "higher"), f"{e['name']}: better is "
          "lower or higher")
    _need(e["source"] in SOURCES, f"{e['name']}: unknown source")
    if "workloads" in e:
        _need(isinstance(e["workloads"], list) and e["workloads"]
              and set(e["workloads"]) <= cell_names,
              f"{e['name']}: workloads names unknown cells")


def _unique(names: List[str], what: str) -> None:
    dup = {n for n in names if names.count(n) > 1}
    _need(not dup, f"{what} names appear twice: {sorted(dup)}")


def load(root: Path = ROOT) -> Dict[str, Any]:
    path = Path(root) / "BENCHMARK.json"
    raw = path.read_bytes()
    _need(len(raw) <= MAX_BYTES, "BENCHMARK.json is over 64 KiB")
    m = json.loads(raw)
    validate(m, Path(root))
    return m


class Cell:
    """What one workload runs: its entry, configuration and traffic files,
    and the metrics it reports."""

    def __init__(self, m: Dict[str, Any], name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in m["workloads"]}
        if name not in cells:
            raise ManifestError(f"unknown workload {name!r}; the manifest "
                                f"has {sorted(cells)}")
        self.root = Path(root)
        self.workload = cells[name]
        self.name = name
        self.chips = self.workload["chips"]
        entry = {c["name"]: c for c in m["configs"]}[self.workload["config"]]
        self.config = json.loads((self.root / entry["file"]).read_text())
        self.config_reduced = entry["reduced"]
        self.traffic = json.loads(
            (self.root / HERE.name / "traffic"
             / f"{self.workload['traffic']}.json").read_text())
        self.end_to_end = [e for e in m["end_to_end"]
                           if name in e.get("workloads", [name])]
        reported = {e["name"] for e in self.end_to_end}
        e2e_cells = {e["name"]: e.get("workloads") for e in m["end_to_end"]}
        self.per_layer = [
            p for p in m["per_layer"]
            if p["moves"] in reported
            and name in p.get("workloads", e2e_cells[p["moves"]] or [name])]
