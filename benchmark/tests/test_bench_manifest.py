"""The manifest's validation, and a cell added as files plus entries."""

import copy
import json
import shutil
from pathlib import Path

import pytest

from benchmark import manifest
from benchmark.metrics import reader

ROOT = Path(manifest.__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def m():
    return manifest.load(ROOT)


def test_repo_manifest_is_valid_and_every_cell_resolves(m):
    for w in m["workloads"]:
        cell = manifest.Cell(m, w["name"], ROOT)
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {e["name"] for e in cell.end_to_end}
        for p in cell.per_layer:
            assert callable(reader(p["name"]))


def _broken(m, how):
    m = copy.deepcopy(m)
    if how == "name":
        m["workloads"][0]["name"] = "bad name"
    elif how == "unit":
        m["end_to_end"][0]["unit"] = "frames per second"
    elif how == "moves":
        m["per_layer"][0]["moves"] = "no_such_metric"
    elif how == "moves_cells":
        m["per_layer"][0]["workloads"] = [w["name"] for w in m["workloads"]]
    elif how == "chips":
        for w in m["workloads"][:2]:
            w["chips"] = 4
    elif how == "bound":
        m["end_to_end"][0]["bound"] = 0.3
    elif how == "width":
        m["configs"][0]["reduced"] = ["g_dim"]
    elif how == "duplicate":
        m["workloads"].append(dict(m["workloads"][0]))
    elif how == "extra_key":
        m["per_layer"][0]["why"] = "not allowed"
    elif how == "no_setup":
        m["end_to_end"] = [e for e in m["end_to_end"]
                           if e["name"] != "setup_s"]
    elif how == "reader":
        m["per_layer"].append(dict(m["per_layer"][0], name="no_reader"))
    return m


@pytest.mark.parametrize("how", ["name", "unit", "moves", "moves_cells",
                                 "chips", "bound", "width", "duplicate",
                                 "extra_key", "no_setup", "reader"])
def test_manifest_breaches_are_refused(m, how):
    with pytest.raises(manifest.ManifestError):
        manifest.validate(_broken(m, how), ROOT)


def test_a_cell_is_added_by_new_files_and_entries(tmp_path, m):
    """A throwaway configuration, traffic mix and per-layer metric, added
    to a copy of the benchmark as files and manifest entries only, load."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = tmp_path / "benchmark"
    conf = json.loads((bench / "configs" / "dcgan64_smmnist.json")
                      .read_text())
    conf["name"] = "dcgan64_tiny"
    (bench / "configs" / "dcgan64_tiny.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic" / "eval.json").read_text())
    mix["nsample"] = 4
    (bench / "traffic" / "eval_s4.json").write_text(json.dumps(mix))
    (bench / "metrics" / "calls_traced.py").write_text(
        "def read(trace, ctx):\n    return float(trace.units)\n")
    m2 = copy.deepcopy(m)
    m2["configs"].append({"name": "dcgan64_tiny", "source": "https://x.y",
                          "file": "benchmark/configs/dcgan64_tiny.json",
                          "reduced": [], "why": "a throwaway"})
    m2["workloads"].append({"name": "dcgan64_tiny.eval_s4",
                            "config": "dcgan64_tiny", "traffic": "eval_s4",
                            "chips": 1, "why": "a throwaway"})
    for e in m2["end_to_end"]:
        if e["name"] == "eval_frames_per_s":
            e["workloads"].append("dcgan64_tiny.eval_s4")
    m2["per_layer"].append({"name": "calls_traced", "unit": "calls",
                            "better": "higher", "source": "device_trace",
                            "layer": "card", "moves": "eval_frames_per_s",
                            "workloads": ["dcgan64_tiny.eval_s4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m2))
    loaded = manifest.load(tmp_path)
    cell = manifest.Cell(loaded, "dcgan64_tiny.eval_s4", tmp_path)
    assert cell.config["name"] == "dcgan64_tiny"
    assert cell.traffic["nsample"] == 4
    names = [p["name"] for p in cell.per_layer]
    assert "calls_traced" in names
    read = reader("calls_traced", bench / "metrics")

    class T:
        units = 3
    assert read(T(), {}) == 3.0
