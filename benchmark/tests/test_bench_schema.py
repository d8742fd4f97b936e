"""The result object a run prints last: its keys, their order, and what
each holds, from tiny runs on the CPU (no card: `run_cell` is driven
directly, past the look for one)."""

import json

import pytest

from benchmark import run
from benchmark.tests import cells

TINY = {"model": {"g_dim": 8, "rnn_size": 16, "num_inducing_points": 4},
        "nsample": 2, "n_eval": 17, "batch_size": 2, "warmup_calls": 1,
        "trace_units": 1, "dtype": "float32"}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def cell():
    return cells.cell("dcgan64_smmnist.eval")


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema(cell, trace):
    res, code = run.run_cell(cell, 2 ** 31 + 5, 0.2, bool(trace), "cpu",
                             overrides=TINY)
    assert code == 0
    keys = list(res)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in res) == bool(trace)
    json.loads(json.dumps(res))
    assert isinstance(res["correct"], bool)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(res["metrics"]) == names
        assert res["metrics"]["setup_s"]["value"] > 0
    for name, (value, limit) in res["checks"].items():
        assert isinstance(value, float) and isinstance(limit, float), name
