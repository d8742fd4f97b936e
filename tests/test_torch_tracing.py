"""The port's program spans (`dvg_tpu_torch.utils.profiling.span`) on the
CPU, at the tiny widths of the port's other tests:

  * with no profiler recording, `span` hands out one shared no-op per name;
    under one, a `record_function`, also through the decorator form;
  * one train step under `torch.profiler` holds every `dvg.train.*` span
    at its count per step, each inside `dvg.train.step`;
  * one `diverse_metrics` call holds `dvg.eval.prepare` and
    `dvg.eval.context` once, `encode`, `lstm`, `decode` and `score` once
    per free step, and `gp_draw` once per fork step;
  * the step's metrics and state and the call's outputs are bit-equal with
    and without the profiler;
  * the exported `diverse_metrics` program holds no profiler node.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvg_tpu_torch.config import DVGConfig
from dvg_tpu_torch.generate.rollout import fork_schedule, make_rollout_fns
from dvg_tpu_torch.models.dvg import DVGModel
from dvg_tpu_torch.serve.export import _Program
from dvg_tpu_torch.train import make_train_step, train_state
from dvg_tpu_torch.utils.profiling import span

TRAIN = dict(dataset="smmnist", channels=1, image_width=64, batch_size=2,
             n_past=2, n_future=1, n_eval=4, g_dim=8, rnn_size=16,
             num_inducing_points=4, epoch_size=3, ft=True)
# 30 free steps from n_past 2: forks at steps 15 and 30
EVAL = dict(dataset="smmnist", channels=1, image_width=64, batch_size=2,
            n_past=2, n_eval=32, g_dim=8, rnn_size=16, num_inducing_points=4,
            nsample=1, use_pallas=True)
STEP_COUNTS = {"dvg.train.step": 1, "dvg.train.joint.forward": 1,
               "dvg.train.joint.backward": 1, "dvg.train.ft.encode": 1,
               "dvg.train.ft.lstm": 1, "dvg.train.ft.gp": 1,
               "dvg.train.bn_fold": 3, "dvg.train.optim": 6}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dvg_spans(prof):
    """The profile's dvg.* host events as (name, start µs, end µs)."""
    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events() if ev.name.startswith("dvg.")]


def recorded(fn):
    """fn()'s result and its dvg.* spans, run under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, dvg_spans(prof)


def test_span_is_a_shared_no_op_while_nothing_records():
    assert not torch.autograd.profiler._is_profiler_enabled
    idle = span("dvg.test.idle")
    assert idle is span("dvg.test.idle")
    assert not isinstance(idle, torch.autograd.profiler.record_function)
    with idle as entered:
        assert entered is None

    @span("dvg.test.decorated")
    def add(a, b):
        return a + b

    def both():
        with span("dvg.test.region"):
            assert isinstance(span("dvg.test.region"),
                              torch.autograd.profiler.record_function)
            return add(1, 2) + add(3, 4)
    out, spans = recorded(both)
    assert out == 10
    assert Counter(n for n, _, _ in spans) == {"dvg.test.region": 1,
                                               "dvg.test.decorated": 2}
    assert add(5, 6) == 11 and span("dvg.test.idle") is idle


def _state(seed=3):
    cfg = DVGConfig(**TRAIN)
    return cfg, train_state(DVGModel(cfg, seed=seed, device="cpu"), cfg)


def test_train_step_spans_and_bit_equal_numbers():
    x = torch.from_numpy(np.random.RandomState(0).rand(
        3, 2, 64, 64, 1).astype(np.float32))
    cfg, plain = _state()
    _, traced = _state()
    step = make_train_step(cfg)
    _, m_plain = step(plain, x)
    (_, m_traced), spans = recorded(lambda: step(traced, x))

    counts = Counter(n for n, _, _ in spans)
    assert counts == STEP_COUNTS
    (_, a, b), = [s for s in spans if s[0] == "dvg.train.step"]
    for name, s, e in spans:
        assert a <= s <= e <= b, name
    for k in m_plain:
        assert torch.equal(m_plain[k], m_traced[k]), k
    sd_plain, sd_traced = (st.model.state_dict() for st in (plain, traced))
    for k in sd_plain:
        assert torch.equal(sd_plain[k], sd_traced[k]), k


def test_eval_call_spans_and_bit_equal_outputs():
    cfg = DVGConfig(**EVAL)
    model = DVGModel(cfg, seed=5, device="cpu")
    fns = make_rollout_fns(model, cfg)
    x = torch.from_numpy(np.random.RandomState(1).rand(
        32, 2, 64, 64, 1).astype(np.float32))
    plain = fns.diverse_metrics(x, seed=7, device="cpu")
    traced, spans = recorded(lambda: fns.diverse_metrics(x, seed=7,
                                                         device="cpu"))

    n_free = cfg.n_eval - cfg.n_past
    forks = int(fork_schedule(cfg.n_past, cfg.n_eval).sum())
    assert forks == 2
    assert Counter(n for n, _, _ in spans) == {
        "dvg.eval.prepare": 1, "dvg.eval.context": 1,
        "dvg.eval.encode": n_free, "dvg.eval.lstm": n_free,
        "dvg.eval.decode": n_free, "dvg.eval.score": n_free,
        "dvg.eval.gp_draw": forks}
    # every span closes before the step's frames go to the consumer: no
    # two spans overlap
    ordered = sorted((s, e) for _, s, e in spans)
    assert all(e <= s2 for (_, e), (s2, _) in zip(ordered, ordered[1:]))
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k


def test_exported_program_holds_no_profiler_node():
    cfg = DVGConfig(**dict(EVAL, n_eval=4))
    fns = make_rollout_fns(DVGModel(cfg, seed=5, device="cpu"), cfg)
    x = torch.zeros((4, 2, 64, 64, 1))
    with torch.no_grad():
        exported = torch.export.export(
            _Program(fns.cores.diverse_metrics, fns.prepare()),
            (x, torch.zeros((), dtype=torch.int64)))
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t
                            or "record_function" in t]
