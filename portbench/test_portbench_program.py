"""``portbench/program.py`` on synthetic spans and device intervals, and on a
CPU profile: idle split at span boundaries, self time, ``outside_program``,
the clock check, the per-layer numbers, and nothing at all where the program
records no spans."""
import threading

import pytest
import torch

from portbench import program
from portbench.program import Span

MAIN, WORKER = 1, 2


def _program(spans, busy, start=0, end=100, **extra):
    return dict({"spans": spans, "counters": {}, "start_ns": start, "end_ns": end,
                 "main_thread": MAIN, "loader_workers": None, "busy": busy, "d2h_ends": [],
                 "launches": []}, **extra)


def test_idle_is_split_at_span_boundaries_under_the_innermost_span():
    spans = [Span(0, "serve.call", None, MAIN, 10, 50, None),
             Span(1, "serve.fetch", None, MAIN, 20, 30, 0),
             Span(2, "loader.sample", None, WORKER, 0, 100, None)]
    # idle: [15, 25] crosses serve.fetch's start, [60, 100] is outside every span
    got = program.idle_by_span(_program(spans, [(0, 15), (25, 60)]))
    assert got == pytest.approx({"outside_program": 40e-9, "serve.call": 5e-9,
                                 "serve.fetch": 5e-9})
    assert program.idle_by_span(_program(spans, [])) is None  # no device operation


@pytest.mark.parametrize("spans, expected", [
    ([], [(0, 100, "outside_program")]),
    ([Span(0, "a", None, MAIN, 10, 90, None), Span(1, "b", None, MAIN, 10, 40, 0),
      Span(2, "c", None, MAIN, 40, 60, 0)],
     [(0, 10, "outside_program"), (10, 40, "b"), (40, 60, "c"), (60, 90, "a"),
      (90, 100, "outside_program")]),
    ([Span(0, "a", None, MAIN, -5, 20, None), Span(1, "d", None, MAIN, 30, 130, None)],
     [(0, 20, "a"), (20, 30, "outside_program"), (30, 100, "d")]),
])
def test_segments_cover_the_window(spans, expected):
    assert program.segments(spans, 0, 100) == expected


def test_self_time_leaves_out_the_children():
    spans = [Span(0, "train.step", 0, MAIN, 0, 40, None),
             Span(1, "graph.replay", "k", MAIN, 5, 35, 0),
             Span(2, "graph.copy_in", "k", MAIN, 5, 10, 1),
             Span(3, "graph.launch", "k", MAIN, 10, 30, 1),
             Span(4, "train.step", 1, MAIN, 50, 60, None)]
    table = program.span_table(spans)
    assert table["train.step"] == pytest.approx([2, 50e-9, 20e-9])
    assert table["graph.replay"] == pytest.approx([1, 30e-9, 5e-9])
    assert table["graph.launch"] == pytest.approx([1, 20e-9, 20e-9])


def test_clock_check_reads_the_fetches_and_the_launches():
    ms = 1_000_000
    spans = [Span(0, "serve.fetch", None, MAIN, 1 * ms, 2 * ms, None),
             Span(1, "serve.fetch", None, MAIN, 10 * ms, 11 * ms, None),
             Span(2, "graph.launch", "k", MAIN, 3 * ms, 4 * ms, None),
             Span(3, "graph.launch", "k", MAIN, 20 * ms, 21 * ms, None)]
    # the first fetch's copy ends inside it, the second's a ms after it; the first
    # launch's kernels start after it began, the second's before (a clock apart)
    prog = _program(spans, [(0, 1)], end=30 * ms, d2h_ends=[int(1.9 * ms), 12 * ms],
                    launches=[(int(3.5 * ms), 5 * ms), (int(20.5 * ms), int(19.9 * ms))])
    assert program.clock_check(prog) == {
        "serve.fetch": 0.5, "graph.launch": 0.5, "profile_clock_ahead_us": None,
        "graph_launches_seen": 2,
        "launch_call_after_span_us": [500.0, 500.0, 500.0],
        "first_device_op_after_span_us": [-100.0, -100.0, 2000.0]}
    assert program.clock_check(_program([], [])) == {
        "serve.fetch": None, "graph.launch": None, "profile_clock_ahead_us": None,
        "graph_launches_seen": 0,
        "launch_call_after_span_us": None, "first_device_op_after_span_us": None}


@pytest.mark.parametrize("seen, expected", [
    ([(120, 130), (1120, 1130)], (-80, 20, 0)),  # one clock: left as it is
    ([(2120, 2130), (3120, 3130)], (1920, 2020, 1920)),  # the profile 2 us ahead
    ([(120, 130), (3120, 3130)], (-80, 2020, 0)),  # drifted between the marks: the hull
])
def test_clock_shift_is_the_least_that_the_marks_call_for(seen, expected):
    marks = [(100, 210), (1100, 1210)]  # time.time_ns() around each mark
    assert program.clock_shift(marks, seen) == expected
    assert program.clock_shift(marks[:1], seen[:1]) is None


def test_layer_metrics_of_serving_and_training():
    ms = 1_000_000
    serve = [Span(0, "serve.call", (144,) * 3, MAIN, 0, 60 * ms, None),
             Span(1, "serve.stage", None, MAIN, 0, 8 * ms, 0),
             Span(2, "graph.replay", "k", MAIN, 8 * ms, 10 * ms, 0),
             Span(3, "serve.fetch", None, MAIN, 10 * ms, 30 * ms, 0),
             Span(4, "serve.call", (144,) * 3, MAIN, 100 * ms, 150 * ms, None),
             Span(5, "serve.stage", None, MAIN, 100 * ms, 104 * ms, 4),
             Span(6, "graph.replay", "k", MAIN, 104 * ms, 106 * ms, 4),
             Span(7, "serve.fetch", None, MAIN, 106 * ms, 126 * ms, 4),
             Span(8, "graph.replay", "e", MAIN, 200 * ms, 300 * ms, None)]  # not serving's
    got = program.layer_metrics(_program(serve, [], end=400 * ms))
    assert got["stage_ms.serve"] == pytest.approx(6.0)
    assert got["replay_host_ms.serve"] == pytest.approx(2.0)
    assert got["fetch_wait_ms.serve"] == pytest.approx(20.0)
    assert got["step_host_ms.train"] is None and got["loader_busy_pct.train"] is None
    train = [Span(0, "train.batch", (1, 0), MAIN, 0, 2 * ms, None),
             Span(1, "train.step", 0, MAIN, 2 * ms, 12 * ms, None),
             Span(2, "train.drain", (1, 0), MAIN, 12 * ms, 42 * ms, None),
             Span(3, "train.batch", (1, 1), MAIN, 50 * ms, 54 * ms, None),
             Span(4, "train.step", 1, MAIN, 54 * ms, 60 * ms, None),
             Span(5, "loader.sample", (1, 0), WORKER, -50 * ms, 50 * ms, None),
             Span(6, "loader.sample", (1, 1), WORKER + 1, 20 * ms, 70 * ms, None)]
    got = program.layer_metrics(_program(train, [], end=100 * ms, loader_workers=4))
    assert got["batch_ms.train"] == pytest.approx(3.0)
    assert got["step_host_ms.train"] == pytest.approx(8.0)
    assert got["drain_ms.train"] == pytest.approx(15.0)
    assert got["loader_busy_pct.train"] == pytest.approx(100.0 * 100 / 400)
    assert got["stage_ms.serve"] is None


def test_nothing_where_the_program_records_no_spans(monkeypatch):
    from hdenseformer_tpu_torch.utils import profiling

    with program.traced(False) as recording:
        assert recording is None and profiling._RECORDING is None
    record = {"kind": "serve", "diagnostics": {}}
    program.attach(record, None, None)
    assert record == {"kind": "serve", "diagnostics": {}}
    monkeypatch.delattr(profiling, "tracing")  # a program from before the spans
    with program.traced(True) as recording:
        assert recording is None


def test_attach_reads_a_recording_beside_a_cpu_profile():
    from hdenseformer_tpu_torch.utils.profiling import span

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with program.traced(True) as window:
            with span("serve.call"), span("serve.fetch"):
                torch.ones(4).sum()
    record = {"kind": "serve", "diagnostics": {"kept": 1}}
    program.attach(record, window, prof)
    prog = record["program"]
    least, most, chosen = prog["profile_clock_ahead_us"]
    assert least <= 0 <= most and chosen == 0  # one clock
    assert prog["start_ns"] < prog["spans"][-1].start_ns <= prog["spans"][-1].end_ns < prog[
        "end_ns"]
    assert [s.name for s in prog["spans"]] == ["serve.fetch", "serve.call"]
    assert prog["main_thread"] == threading.get_native_id() == prog["spans"][0].thread
    assert prog["busy"] == [] and record["diagnostics"]["kept"] == 1
    diag = record["diagnostics"]
    assert diag["idle_by_program_span"] is None  # the CPU profile has no device
    assert diag["clock_check"]["serve.fetch"] == 0.0  # no device-to-host copy
    assert set(diag["program_spans"]) == {"serve.call", "serve.fetch"}
    assert diag["program_metrics"]["fetch_wait_ms.serve"] >= 0
