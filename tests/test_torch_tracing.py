"""The port's spans and counters (``utils/profiling.py``), on the CPU.

Off, ``span`` returns one shared no-op and ``count`` records nothing;
inside ``tracing()`` spans nest by thread, with their parents, from the
loader's worker threads too, on the profiler's clock. The serving call,
the captured call, the train step, the trainer loop and the loader record
the spans that PERF.md lists, in the order the work runs; ``profiler_trace``
writes the spans into its Chrome trace and the counters beside it.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hdenseformer_tpu_torch.data.pipeline import BatchLoader, SegDataset  # noqa: E402
from hdenseformer_tpu_torch.data.transforms import ToOneHot  # noqa: E402
from hdenseformer_tpu_torch.infer import sliding  # noqa: E402
from hdenseformer_tpu_torch.losses import get_loss  # noqa: E402
from hdenseformer_tpu_torch.models.hdenseformer import HDenseFormer  # noqa: E402
from hdenseformer_tpu_torch.train.loop import (  # noqa: E402
    CapturedTrainStep,
    SemanticSeg,
    TrainState,
)
from hdenseformer_tpu_torch.utils import profiling  # noqa: E402
from hdenseformer_tpu_torch.utils.profiling import (  # noqa: E402
    count,
    profiler_trace,
    span,
    tracing,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _children(rec, parent):
    return [s for s in sorted(rec.spans, key=lambda s: s.start_ns) if s.parent == parent.id]


def _named(rec, name):
    return sorted((s for s in rec.spans if s.name == name), key=lambda s: s.start_ns)


@pytest.mark.parametrize("key", [None, 7, (1, 2)])
def test_off_records_nothing_and_returns_the_shared_no_op(key):
    a, b = span("x", key), span("y")
    assert a is b is profiling._NO_SPAN
    with a:
        count("c", 3)
    with tracing() as rec:
        pass
    with span("z", key):  # after tracing() ended: off again
        count("c")
    assert rec.spans == [] and rec.counters == {}
    assert rec.start_ns <= rec.end_ns


def test_tracing_does_not_nest_and_drops_spans_that_outlive_it():
    with tracing():
        with pytest.raises(RuntimeError, match="does not nest"):
            with tracing():
                pass
    outliving = None
    with tracing() as rec:
        outliving = span("late")
        outliving.__enter__()
    outliving.__exit__(None, None, None)
    assert rec.spans == []


def test_nesting_gives_parents_and_self_times():
    with tracing() as rec:
        with span("outer", 1):
            time.sleep(0.002)
            with span("inner", (1, 0)):
                time.sleep(0.004)
                count("n", 2)
            with span("inner", (1, 1)):
                time.sleep(0.004)
            count("n")
        with span("next"):
            pass
    (outer,), inner, (nxt,) = _named(rec, "outer"), _named(rec, "inner"), _named(rec, "next")
    assert outer.parent is None and nxt.parent is None and outer.key == 1
    assert [s.parent for s in inner] == [outer.id, outer.id]
    assert [s.key for s in inner] == [(1, 0), (1, 1)]
    assert {s.thread for s in rec.spans} == {threading.get_native_id()}
    for s in inner:
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
        assert s.end_ns - s.start_ns >= 4e6
    self_ns = (outer.end_ns - outer.start_ns) - sum(s.end_ns - s.start_ns for s in inner)
    assert 2e6 <= self_ns <= (outer.end_ns - outer.start_ns) - 8e6
    assert rec.counters == {"n": 3}


def test_loader_worker_threads_record_their_samples():
    store = {f"c{i}": (np.full((1, 4, 4, 4), i, np.float32), np.zeros((4, 4, 4), np.uint8))
             for i in range(6)}
    ds = SegDataset(sorted(store), roi_number=None, num_class=2,
                    transform=ToOneHot(num_class=2, input_channel=1),
                    reader=lambda path, key: store[path][0 if key == "ct" else 1])
    loader = BatchLoader(ds, 2, shuffle=True, num_workers=3, seed=5)
    with tracing() as rec:
        batches = list(loader.epoch(4))
    assert len(batches) == 3
    samples = _named(rec, "loader.sample")
    assert sorted(s.key for s in samples) == [(4, i) for i in range(6)]
    main = threading.get_native_id()
    assert main not in {s.thread for s in samples}
    producer = {s.thread for s in _named(rec, "loader.stack")}
    assert len(producer) == 1 and main not in producer
    assert [s.key for s in _named(rec, "loader.stack")] == [(4, b) for b in range(3)]
    assert [s.key for s in _named(rec, "loader.put_wait")] == [(4, b) for b in range(3)]
    (start,) = _named(rec, "loader.epoch_start")
    first_stack = _named(rec, "loader.stack")[0]
    assert first_stack.parent == start.id
    assert start.end_ns <= _named(rec, "loader.put_wait")[0].start_ns
    assert rec.counters["loader.samples"] == 6
    assert set(rec.threads) >= {s.thread for s in rec.spans}


def test_a_span_and_a_record_function_share_the_profilers_clock():
    with tracing() as rec, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with span(f"probe{i}"), torch.profiler.record_function(f"probe{i}"):
                torch.ones(8).sum()
    ours = {s.name: s for s in rec.spans}
    theirs = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe")}
    assert set(theirs) == set(ours) == {"probe0", "probe1", "probe2"}
    for name, s in ours.items():
        assert abs(theirs[name].start_ns() - s.start_ns) < 1e6
        assert abs(theirs[name].end_ns() - s.end_ns) < 1e6


PATCH = (32, 32, 32)


@pytest.fixture(scope="module")
def small_model():
    torch.manual_seed(0)
    return HDenseFormer(2, 2, 4, PATCH, 2, device="cpu").eval()


def test_predict_volume_records_one_call_a_volume_in_order(small_model):
    vols = [np.random.RandomState(i).randn(2, *PATCH).astype(np.float32) for i in range(2)]
    with tracing() as rec:
        labels = [sliding.predict_volume(small_model, v, PATCH, (16,) * 3, 2, capture=True)
                  for v in vols]
    assert all(lab.shape == PATCH and lab.dtype == np.int32 for lab in labels)
    calls = _named(rec, "serve.call")
    assert [c.key for c in calls] == [PATCH, PATCH] and all(c.parent is None for c in calls)
    for call in calls:
        kids = _children(rec, call)
        assert [k.name for k in kids] == ["serve.plan", "serve.stage", "graph.replay",
                                          "serve.fetch", "serve.crop"]
        (replay,) = [k for k in kids if k.name == "graph.replay"]
        assert [k.name for k in _children(rec, replay)] == ["graph.copy_in", "graph.launch"]
        assert replay.key[0] == "sliding"
    (warmup,) = _named(rec, "graph.warmup")  # the lattice cell's call, made once
    assert warmup.parent == _children(rec, calls[0])[0].id
    assert rec.counters == {"serve.volumes": 2, "serve.windows": 2, "serve.windows_run": 2,
                            "serve.staged_bytes": 2 * 2 * 32 ** 3 * 4, "graphs.replayed": 2}


class _Tiny(torch.nn.Module):
    """A channels-last per-voxel linear layer: the step's host side costs
    next to nothing."""

    def __init__(self):
        super().__init__()
        self.head = torch.nn.Linear(1, 2)

    def forward(self, x, generator=None):
        return self.head(x)


def test_run_epoch_records_the_steps_and_the_drains():
    n_cases = 12
    store = {f"c{i:02d}": (np.random.RandomState(i).randn(1, 4, 4, 4).astype(np.float32),
                           (np.arange(64).reshape(4, 4, 4) % (i + 2) == 0).astype(np.uint8))
             for i in range(n_cases)}
    ds = SegDataset(sorted(store), roi_number=None, num_class=2,
                    transform=ToOneHot(num_class=2, input_channel=1),
                    reader=lambda path, key: store[path][0 if key == "ct" else 1])
    seg = SemanticSeg(net_name="unet_3d", channels=1, num_classes=2, roi_number=None,
                      input_shape=(16, 16, 16), batch_size=1, num_workers=2, device="cpu",
                      use_fp16=False, seed=0, n_epoch=1)
    model = _Tiny()
    state = TrainState(model, torch.optim.Adam(model.parameters(), 1e-3))
    step = CapturedTrainStep(get_loss("Cross_Entropy"), 2)
    loader = BatchLoader(ds, 1, shuffle=True, num_workers=2, seed=0)
    with tracing() as rec:
        state, out = seg._run_epoch(state, loader, step, 3, (torch.Generator(), None),
                                    train=True)
    assert out["steps"] == n_cases and state.step == n_cases
    keys = [(3, i) for i in range(n_cases)]
    assert [s.key for s in _named(rec, "train.loader_wait")] == keys + [(3, n_cases)]
    for name in ("train.batch", "train.seed"):
        assert [s.key for s in _named(rec, name)] == keys, name
    assert [s.key for s in _named(rec, "train.step")] == list(range(n_cases))
    # global steps 0 and 10, then the epoch's end
    assert [s.key for s in _named(rec, "train.drain")] == [(3, 0), (3, 10), (3, n_cases)]
    main = threading.get_native_id()
    assert all(s.thread == main and s.parent is None for s in rec.spans if s.name.startswith(
        "train."))
    assert rec.counters["loader.samples"] == n_cases


def test_profiler_trace_writes_the_spans_and_the_counters(tmp_path):
    with profiler_trace(str(tmp_path)) as path:
        with span("outer", (2, 3)):
            with span("inner"), torch.profiler.record_function("beside_inner"):
                torch.relu(torch.randn(32, 32) @ torch.randn(32, 32))
            count("widgets", 5)
        worker = threading.Thread(target=lambda: span("on_a_thread").__enter__().__exit__(),
                                  name="worker-a")
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "program"}
    assert set(ours) == {"outer", "inner", "on_a_thread"}
    assert ours["outer"]["args"]["key"] == [2, 3]
    assert ours["inner"]["args"]["parent"] == ours["outer"]["args"]["id"]
    assert ours["on_a_thread"]["tid"] != ours["outer"]["tid"]
    (beside,) = [e for e in events if e.get("name") == "beside_inner" and e.get("ph") == "X"]
    assert abs(beside["ts"] - ours["inner"]["ts"]) < 1e3  # microseconds: one time base
    assert {"name": "worker-a"} in [e["args"] for e in events if e.get("ph") == "M"
                                     and e.get("tid") == ours["on_a_thread"]["tid"]]
    stem = os.path.basename(path)[len("trace."):]
    with open(tmp_path / f"counters.{stem}") as f:
        assert json.load(f) == {"widgets": 5}
    assert profiling._RECORDING is None
