"""Cells for the tests, including those whose files are in the benchmark
but whose entries are not in BENCHMARK.json (added to a copy of the
manifest, as a later PR would add them): DCGAN-64's eval protocol, out
until the program's bf16 GP draw is held (PERF.md), still serves the tests
that need no limits."""

import copy

from benchmark import manifest

PENDING = {"dcgan64_smmnist.eval": ("dcgan64_smmnist", "eval")}


def cell(name: str) -> manifest.Cell:
    m = manifest.load()
    if name in PENDING and name not in {w["name"] for w in m["workloads"]}:
        m = copy.deepcopy(m)
        config, traffic = PENDING[name]
        m["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "pending"})
    return manifest.Cell(m, name)
