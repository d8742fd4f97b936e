"""The program-span arithmetic (`yardstick.spans`) and its seven readers on
synthetic traces, and a CPU capture of a unit that opens a `dvg.*` span."""

import pytest

from benchmark.metrics import reader
from benchmark.yardstick import spans as S
from benchmark.yardstick import trace as T


def _trace(device, host=(), runtime=(), units=1, window=(0.0, 1000.0),
           sync=(900.0, 1000.0)):
    spans = [(T.WINDOW, *window), ("bench.step", window[0], sync[0]),
             ("bench.sync", *sync)]
    return T.Trace(list(device), list(runtime), spans, list(host), units)


# a step 0-900 holding the joint pass (forward 0-300 with an aten op in it,
# backward 300-500), an update 500-600 and the finetune 600-800
STEP = [("dvg.train.step", 0.0, 900.0),
        ("dvg.train.joint.forward", 0.0, 300.0),
        ("aten::mm", 50.0, 150.0),
        ("dvg.train.joint.backward", 300.0, 500.0),
        ("dvg.train.optim", 500.0, 600.0),
        ("dvg.train.ft.lstm", 600.0, 800.0)]
DEVICE = [("k", 100.0, 250.0), ("k", 350.0, 450.0), ("k", 650.0, 950.0)]


def test_idle_parts_sum_to_the_idle_gaps_and_take_the_innermost_span():
    tr = _trace(DEVICE, STEP)
    parts = S.idle_by_span(tr)
    assert sum(parts.values()) == pytest.approx(
        sum(e - s for s, e in T.idle_gaps(tr)))
    assert sum(parts.values()) / 1e6 == pytest.approx(
        tr.window_s * T.idle_pct(tr) / 100)
    # idle 0-100 and 250-300 under the forward (not its aten op, not the
    # step); 300-350 and 450-500 under the backward; 500-600 under the
    # optimizer; 600-650 under the finetune; 950-1000 outside every span
    assert parts == {"dvg.train.joint.forward": 150.0,
                     "dvg.train.joint.backward": 100.0,
                     "dvg.train.optim": 100.0, "dvg.train.ft.lstm": 50.0,
                     S.OUTSIDE: 50.0}


def test_spans_and_gaps_are_clipped_to_the_window():
    host = [("dvg.train.step", -500.0, 400.0),
            ("dvg.train.optim", 950.0, 1500.0)]
    tr = _trace([("k", -100.0, 100.0), ("k", 200.0, 300.0)], host)
    assert S.spans_of(tr) == [("dvg.train.step", 0.0, 400.0),
                              ("dvg.train.optim", 950.0, 1000.0)]
    assert S.idle_by_span(tr) == {"dvg.train.step": 200.0,
                                  S.OUTSIDE: 550.0, "dvg.train.optim": 50.0}
    assert S.host_ms(tr, "dvg.train.step") == 0.4


def test_a_span_of_no_length_takes_no_idle():
    host = [("dvg.eval.encode", 0.0, 500.0), ("dvg.eval.lstm", 500.0, 500.0)]
    tr = _trace([("k", 600.0, 700.0)], host)
    assert S.idle_by_span(tr) == {"dvg.eval.encode": 500.0,
                                  S.OUTSIDE: 400.0}


def test_waits_count_inside_the_spans_and_never_inside_bench_sync():
    rt = [("cudaStreamSynchronize", 10.0, 20.0),      # in the forward
          ("cudaMemcpyAsync", 30.0, 31.0),             # async: no wait
          ("cudaMemcpy", 520.0, 530.0),                # in the optimizer
          ("cudaLaunchKernel", 540.0, 541.0),
          ("cudaStreamSynchronize", 850.0, 860.0),     # in the step alone
          ("cudaDeviceSynchronize", 910.0, 990.0)]     # the benchmark's
    tr = _trace(DEVICE, STEP, rt, units=2)
    assert S.host_waits(tr, "dvg.train.step") == 3
    assert S.host_waits(tr, "dvg.train.joint.") == 1
    assert S.host_waits(tr, "dvg.eval.") is None
    assert reader("host_waits_per_step.train")(tr, {}) == 1.5
    # a wait in a span that reaches into bench.sync is still not counted
    host = [("dvg.eval.score", 0.0, 1000.0)]
    tr = _trace(DEVICE, host, rt, units=1)
    assert reader("host_waits_per_call.eval")(tr, {}) == 3
    assert reader("host_waits_per_call.eval")(_trace(DEVICE, host), {}) == 0


def test_train_readers_split_the_idle_by_pass():
    tr = _trace(DEVICE, STEP + [("dvg.train.bn_fold", 800.0, 900.0)],
                units=2)
    assert reader("joint_idle_ms_per_step.train")(tr, {}) == 0.125
    assert reader("ft_idle_ms_per_step.train")(tr, {}) == 0.025
    # the optimizer's 100 µs and nothing of the fold: the card ran then
    assert reader("update_idle_ms_per_step.train")(tr, {}) == 0.05


def test_eval_readers():
    host = [("dvg.eval.prepare", 0.0, 200.0),
            ("dvg.eval.gp_draw", 400.0, 500.0),
            ("dvg.eval.gp_draw", 600.0, 700.0)]
    tr = _trace([("k", 100.0, 450.0), ("k", 650.0, 900.0)], host, units=2)
    assert reader("prepare_ms_per_call.eval")(tr, {}) == 0.1
    assert reader("gp_draw_idle_ms_per_call.eval")(tr, {}) == 0.05


@pytest.mark.parametrize("name", [
    "host_waits_per_step.train", "joint_idle_ms_per_step.train",
    "ft_idle_ms_per_step.train", "update_idle_ms_per_step.train",
    "prepare_ms_per_call.eval", "host_waits_per_call.eval",
    "gp_draw_idle_ms_per_call.eval"])
def test_readers_find_nothing_without_the_programs_spans(name):
    rt = [("cudaStreamSynchronize", 10.0, 20.0)]
    tr = _trace(DEVICE, [("aten::mm", 50.0, 150.0)], rt)
    assert reader(name)(tr, {}) is None


def test_a_captured_dvg_span_lands_in_host_alone():
    import torch
    from dvg_tpu_torch.utils.profiling import span

    def unit():
        with span("dvg.test.unit"):
            torch.ones(4).sum()
    tr = T.capture(unit, 2)
    names = [n for n, _, _ in tr.host]
    assert names.count("dvg.test.unit") == 2
    assert sorted(n for n, _, _ in tr.spans) == ["bench.sync",
                                                 "bench.window"]
    assert tr.device == []
    assert S.host_ms(tr, "dvg.test.") > 0
