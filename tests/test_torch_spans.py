"""PyTorch port, the span recorder (pathtracer_tpu_torch/utils/spans.py)
and the benchmark's readers of it (benchmark/spans.py,
benchmark/metrics/).

On the CPU: the recorder's parents, calls and self times, its medians
without the spans the profiler saw, its bounded lists, the in-graph
events' boundary arithmetic and the timed replays' schedule and reading
with stand-in events, the host spans of a CPU load, render and display,
the compiled frame's spans and timed replays with graphs that run the
iteration on the CPU, the switch in frame_key, the switch off (no spans,
the same bits), the operator's report, and each reader: None on a CPU
run, the value on a synthetic snapshot. The `cuda` tests hold the in-graph
stage sums to events outside the graph around one timed replay, and the
images with a timed graph captured and replayed and without one to each
other bit for bit; they skip without a device. On the card, without JAX:
    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_spans.py -m cuda
"""
import ast
import contextlib
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import load_scene
from pathtracer_tpu_torch.engine import wavefront
from pathtracer_tpu_torch.engine.wavefront import (Frame,
                                                   capturable_iteration,
                                                   frame_key, lanes_to_image,
                                                   zero_accum)
from pathtracer_tpu_torch.io import image
from pathtracer_tpu_torch.io.image import to_uint8
from pathtracer_tpu_torch.scene import loader
from pathtracer_tpu_torch.scene.fixtures import scene_path
from pathtracer_tpu_torch.utils import profiling, spans

torch.set_num_threads(2)

NEW_METRICS = ("stage_raygen_ms", "stage_intersect_ms", "stage_shade_ms",
               "stage_gather_ms", "render_host_ms", "display_fetch_ms",
               "display_u8_ms", "setup_capture_s", "setup_scene_s",
               "graph_captures")


@pytest.fixture
def fresh():
    """A fresh recorder, with the switch on; reset again afterwards."""
    spans.reset()
    with mock.patch.object(spans, "ENABLED", True):
        yield
    spans.reset()


def _load(name="cornell", res=16, depth=2, device="cpu"):
    return load_scene(scene_path(name), device,
                      overrides={"RES": [res, res], "DEPTH": depth})


def _bits(acc):
    return torch.stack(tuple(acc)).view(torch.int32)


def test_parents_calls_and_self_times(fresh):
    """Spans nest by their parent ids; a call span opens a call that the
    spans inside carry and those outside do not; a stage is no span; self
    time is a span's duration less its direct children's (synthetic
    records)."""
    with spans.span("pt_frame", call=True):
        with spans.span("pt_frame.key"):
            pass
        with spans.span("pt_frame.launch"):
            with spans.span("pt_frame.copy"):
                with spans.stage("pt_raygen"):
                    pass
    with spans.span("pt_display.u8"):
        pass
    recs = {r[1]: r for r in spans.snapshot()["spans"]}
    assert "pt_raygen" not in recs
    frame = recs["pt_frame"]
    assert frame[4] is None and frame[5] == 1
    assert recs["pt_frame.key"][4] == frame[0]
    assert recs["pt_frame.copy"][4] == recs["pt_frame.launch"][0]
    assert recs["pt_frame.copy"][5] == 1
    assert recs["pt_display.u8"][4] is None
    assert recs["pt_display.u8"][5] is None
    assert all(r[2] <= r[3] for r in recs.values())
    synthetic = [[1, "pt_frame", 0.0, 10.0, None, 1, False],
                 [2, "pt_frame.key", 1.0, 2.0, 1, 1, False],
                 [3, "pt_frame.launch", 3.0, 7.0, 1, 1, False],
                 [4, "pt_raygen", 4.0, 5.0, 3, 1, False],
                 [5, "pt_display.u8", 11.0, 13.0, None, None, False]]
    assert spans.self_seconds(synthetic) == {1: 5.0, 2: 1.0, 3: 3.0,
                                             4: 1.0, 5: 2.0}


def test_medians_leave_out_the_profiled(fresh):
    """A span that ran under torch.profiler is marked traced and no
    median reads it; with only traced samples there is none."""
    from torch.profiler import ProfilerActivity, profile
    assert spans.median([[1.0, False], [100.0, True], [3.0, False]]) == 2.0
    assert spans.median([[1.0, True]]) is None
    assert spans.median(None) is None
    with spans.span("pt_display.u8"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("pt_display.u8"):
            pass
    assert "pt_display.u8" in {e.name for e in prof.events()}
    snap = spans.snapshot()
    assert [t for _, t in snap["host_s"]["pt_display.u8"]] == [False, True]
    assert [r[6] for r in snap["spans"]] == [False, True]
    assert spans.median(snap["host_s"]["pt_display.u8"]) == \
        snap["host_s"]["pt_display.u8"][0][0]


def test_ranges_open_only_while_a_profiler_records(fresh, monkeypatch):
    """Untraced, a span or a stage opens no profiler range (its host
    cost); traced, each opens one of its name. A span is recorded either
    way, a stage never (nothing reads a stage's host time)."""
    opened = []
    monkeypatch.setattr(spans, "record_function", lambda name: (
        opened.append(name), contextlib.nullcontext())[1])
    with spans.stage("pt_shade"):
        pass
    with spans.span("pt_frame.key"):
        pass
    assert opened == [] and len(spans.snapshot()["spans"]) == 1
    monkeypatch.setattr(spans, "profiler_on", lambda: True)
    with spans.span("pt_frame.key"):
        pass
    with spans.stage("pt_mi_sort"):
        pass
    assert opened == ["pt_frame.key", "pt_mi_sort"]
    assert [r[1] for r in spans.snapshot()["spans"]] == ["pt_frame.key"] * 2


class _Timed:
    """A stand-in timed replay: finished, pt_shade took `ms`."""

    def __init__(self, ms):
        self.ms = ms

    def finished(self):
        return True

    def stage_ms(self):
        return {"pt_shade": self.ms}


def test_lists_are_bounded():
    """Every list keeps the newest CAP entries."""
    rec = spans.Recorder(cap=4)
    for k in range(10):
        rec.close(rec.open("pt_frame.key", False, False))
        rec.replayed(_Timed(float(k)))
        rec.read_replay()
    snap = rec.snapshot()
    assert len(snap["spans"]) == 4 and [r[0] for r in snap["spans"]] == [
        7, 8, 9, 10]
    assert len(snap["host_s"]["pt_frame.key"]) == 4
    assert [v for v, _ in snap["device_ms"]["pt_shade"]] == [6.0, 7.0, 8.0,
                                                             9.0]
    assert spans.CAP == 1 << 16 and spans.Recorder().cap == spans.CAP


class _Clock:
    """Stand-in CUDA events: each record takes the next time of `times`
    (ms); query says whether the replay has finished."""

    def __init__(self, times):
        self.times, self.done = list(times), True

    def event(self, enable_timing=False, external=False):
        clock = self
        assert enable_timing and external

        class Ev:
            def record(self):
                self.at = clock.times.pop(0)

            def query(self):
                return clock.done

            def elapsed_time(self, end):
                return end.at - self.at
        return Ev()


def test_graph_events_boundaries_and_reading(fresh, monkeypatch):
    """Two bounces: one event before raygen and one at each stage's end
    (a stage starts where the one before it ended); the pt_mi_* stages
    record none; each stage's ms is summed over its bounces; a timed
    replay is read once, only when it has finished, and keeps the
    profiler's mark of its launch."""
    clock = _Clock([0.0, 1.0, 11.0, 14.0, 14.5, 24.5, 27.5, 28.0])
    monkeypatch.setattr(torch.cuda, "Event", clock.event)
    events = spans.graph_events()
    with spans.capturing(events):
        with spans.stage("pt_raygen"):
            pass
        for _ in range(2):
            with spans.stage("pt_intersect"):
                with spans.stage("pt_mi_cull"):
                    pass
            with spans.stage("pt_shade"):
                pass
            with spans.stage("pt_gather"):
                pass
    assert len(events.events) == 8 and clock.times == []
    assert events.stage_ms() == {"pt_raygen": 1.0, "pt_intersect": 20.0,
                                 "pt_shade": 6.0, "pt_gather": 1.0}
    with spans.stage("pt_raygen"):          # outside a capture: no event
        pass
    assert len(events.events) == 8
    clock.done = False
    spans.replayed(events)
    spans.read_replay()
    assert spans.snapshot()["device_ms"] == {}
    clock.done = True
    spans.read_replay()
    spans.read_replay()
    dev = spans.snapshot()["device_ms"]
    assert dev["pt_intersect"] == [[20.0, False]]
    with mock.patch.object(spans, "profiler_on", lambda: True):
        spans.replayed(events)
    spans.read_replay()
    assert spans.snapshot()["device_ms"]["pt_shade"] == [[6.0, False],
                                                         [6.0, True]]
    assert spans.snapshot()["spans"] == []


def test_timed_replays_are_due_once_a_while(fresh, monkeypatch):
    """A timed replay is due at first, not while one waits to be read,
    and again TIMED_EVERY_S after the last was launched; never with the
    recorder off."""
    assert spans.timed_due()
    spans.replayed(_Timed(1.0))
    assert not spans.timed_due()            # unread
    spans.read_replay()
    assert not spans.timed_due()            # a moment ago
    monkeypatch.setattr(spans, "TIMED_EVERY_S", 0.0)
    spans.replayed(_Timed(2.0))
    assert not spans.timed_due()
    spans.read_replay()
    assert spans.timed_due()
    with mock.patch.object(spans, "ENABLED", False):
        assert not spans.timed_due()
    assert [v for v, _ in spans.snapshot()["device_ms"]["pt_shade"]] == [
        1.0, 2.0]


def test_host_spans_of_a_cpu_load_render_and_display(fresh):
    """load_scene, lanes_to_image and to_uint8 each leave their spans; the
    eager render_chunk of the CPU leaves none (its stages are no spans):
    no frame call, no device sample, no counter."""
    scene, settings = _load("cornell", 16, 2)
    acc = zero_accum(settings, "cpu")
    wavefront.render_chunk(scene, settings, acc, 1, 3)
    to_uint8(lanes_to_image(acc * (1.0 / 3.0), settings))
    snap = spans.snapshot()
    n = {k: len(v) for k, v in snap["host_s"].items()}
    assert n == {"pt_setup.scene": 1, "pt_display.fetch": 1,
                 "pt_display.u8": 1}
    assert snap["device_ms"] == {} and snap["counters"] == {}
    assert all(r[5] is None for r in snap["spans"])


class _FakeGraph:
    def __init__(self, fn):
        self.fn, self.replays = fn, 0

    def replay(self):
        self.replays += 1
        self.fn()


def test_compiled_frame_spans_on_a_cpu_graph(fresh, monkeypatch):
    """render_chunk_compiled with stand-in graphs: each call is a
    pt_frame call; the first warms up and captures, the second only keys,
    copies in, launches and copies out; only the last replay of a call
    that finds a timed replay due is the timed graph's, read at the next
    call or by clear_frames; the image is the eager loop's."""
    scene, settings = _load("cornell", 16, 2)
    graphs = []

    def fake_capture(scene, settings, n, seed, pixel_offset, key_salt,
                     device):
        acc = zero_accum(settings, "cpu", n=n)
        it = torch.zeros((), dtype=torch.int64)
        graphs[:] = [_FakeGraph(lambda: capturable_iteration(
            scene, settings, acc, it, seed, pixel_offset, key_salt))
            for _ in range(2)]
        return Frame(graphs[0], acc, it, {}, {}, 0.0, 0, scene, graphs[1],
                     _Timed(3.5))

    monkeypatch.setattr(wavefront, "capture_frame", fake_capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(spans, "TIMED_EVERY_S", 3600.0)
    wavefront.clear_frames()
    with torch.inference_mode():
        got = zero_accum(settings, "cpu")
        for start in (1, 4):
            wavefront.render_chunk_compiled(scene, settings, got, start, 3)
        assert [g.replays for g in graphs] == [4, 1]
        assert spans.snapshot()["device_ms"] == {"pt_shade": [[3.5,
                                                               False]]}
        spans.reset()
        wavefront.render_chunk_compiled(scene, settings, got, 7, 1)
        wavefront.clear_frames()
        ref = wavefront.render_chunk_eager(scene, settings,
                                           zero_accum(settings, "cpu"), 1, 7)
    assert [g.replays for g in graphs] == [4, 2]
    assert spans.snapshot()["device_ms"] == {"pt_shade": [[3.5, False]]}
    assert torch.equal(_bits(got), _bits(ref))
    spans.reset()
    with torch.inference_mode():
        got = zero_accum(settings, "cpu")
        for start in (1, 4):
            wavefront.render_chunk_compiled(scene, settings, got, start, 3)
    wavefront.clear_frames()
    recs = spans.snapshot()["spans"]
    frames = [r for r in recs if r[1] == spans.FRAME]
    assert [r[5] for r in frames] == [1, 2]
    kids = {c: [r[1] for r in recs if r[4] == f[0]]
            for c, f in zip((1, 2), frames)}
    assert kids[1] == ["pt_frame.key", "pt_frame.warm", "pt_frame.capture",
                       "pt_frame.copy", "pt_frame.launch", "pt_frame.copy"]
    assert kids[2] == ["pt_frame.key", "pt_frame.copy", "pt_frame.launch",
                       "pt_frame.copy"]
    own = spans.self_seconds(recs)
    assert all(own[f[0]] >= 0 for f in frames)


def test_the_switch_is_in_frame_key():
    """A graph captured with events and one without are two cache
    entries."""
    scene, settings = _load("teapot", 16, 2)
    args = (scene, settings, 256, 0, 0, None, "cuda:0")
    assert "utils.spans" in wavefront.BAKED_MODULES
    on = frame_key(*args)
    with mock.patch.object(spans, "ENABLED", False):
        off = frame_key(*args)
    assert on != off and frame_key(*args) == on


def test_switch_off_records_nothing_and_keeps_the_bits(fresh):
    """With ENABLED off: no span, sample or counter, and the image of a
    mesh frame bit for bit the one with the recorder on."""
    scene, settings = _load("teapot", 16, 2)

    def frame():
        acc = zero_accum(settings, "cpu")
        wavefront.render_chunk(scene, settings, acc, 1, 2)
        return _bits(acc), to_uint8(lanes_to_image(acc * 0.5, settings))

    on_bits, on_u8 = frame()
    assert spans.snapshot()["spans"]
    spans.reset()
    with mock.patch.object(spans, "ENABLED", False):
        off_bits, off_u8 = frame()
        spans.count("captures")
        assert spans.graph_events() is None and not spans.timed_due()
    assert spans.snapshot() == {"spans": [], "host_s": {}, "device_ms": {},
                                "counters": {}}
    assert torch.equal(on_bits, off_bits)
    np.testing.assert_array_equal(on_u8, off_u8)


def test_every_span_name_is_listed():
    """The spans the port opens (span(...) calls and decorators) are
    SPANS, and the stages it opens are STAGES."""
    from pathtracer_tpu_torch.ops import binned
    found = {"span": set(), "stage": set()}
    for mod in (wavefront, binned, image, loader):
        for node in ast.walk(ast.parse(open(mod.__file__).read())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", "") in found
                    and getattr(node.func.value, "id", "") == "spans"):
                arg = node.args[0]
                found[node.func.attr].add(
                    spans.FRAME if isinstance(arg, ast.Attribute)
                    else arg.value)
    assert found["span"] == set(spans.SPANS)
    assert found["stage"] == set(spans.STAGES)


def test_operator_report_prints_the_in_graph_stages():
    """format_report prints graph_stages where the recorder read the
    compiled frame, and says why there are none otherwise."""
    rep = {"scene": "s.json", "res": [8, 8], "depth": 2, "bvh": None,
           "fallback": "packet", "mode": "masked", "frame": "compiled",
           "device": "cuda:0", "iters": 3, "frame_ms": 1.0,
           "device_profile": {"wall_ms": 2.0, "device_ms": None},
           "stage_times": {"wall_ms": 3.0, "stages": {}},
           "graph_stages": {"pt_raygen": 0.25, "pt_intersect": 1.5}}
    text = profiling.format_report(rep)
    assert "in-graph stages" in text and "sum 1.750" in text
    assert "pt_intersect" in text
    rep["graph_stages"] = None
    assert "none read" in profiling.format_report(rep)


def test_frame_host_splits_the_calls_that_captured_nothing(fresh,
                                                           monkeypatch):
    """frame_host: the medians of the untraced calls that captured
    nothing, each inside span summed over its call, and the self time
    (synthetic records)."""
    recs = [[1, "pt_frame", 0.0, 1.0, None, 1, False],
            [2, "pt_frame.capture", 0.1, 0.9, 1, 1, False],
            [3, "pt_frame", 2.0, 2.010, None, 2, False],
            [4, "pt_frame.key", 2.001, 2.002, 3, 2, False],
            [5, "pt_frame.copy", 2.002, 2.003, 3, 2, False],
            [6, "pt_frame.launch", 2.003, 2.006, 3, 2, False],
            [7, "pt_frame.copy", 2.006, 2.007, 3, 2, False],
            [8, "pt_frame", 3.0, 3.5, None, 3, True]]
    monkeypatch.setattr(spans, "snapshot", lambda: {"spans": recs})
    got = profiling.frame_host()
    assert got == pytest.approx({"pt_frame": 10.0, "pt_frame.key": 1.0,
                                 "pt_frame.copy": 2.0,
                                 "pt_frame.launch": 3.0, "self": 4.0})
    monkeypatch.setattr(spans, "snapshot", lambda: {"spans": recs[:2]})
    assert profiling.frame_host() is None
    rep = {"scene": "s.json", "res": [8, 8], "depth": 2, "bvh": None,
           "fallback": "packet", "mode": "masked", "frame": "compiled",
           "device": "cuda:0", "iters": 3, "frame_ms": 1.0,
           "device_profile": {"wall_ms": 2.0, "device_ms": None},
           "stage_times": {"wall_ms": 3.0, "stages": {}},
           "graph_stages": None, "frame_host": got}
    assert "pt_frame.launch" in profiling.format_report(rep)


def test_operator_report_prints_the_graph_cache(fresh, monkeypatch):
    """graph_cache: the recorder's captures and evictions counters, and
    the cached frames with their pools' bytes read from the frames; the
    report prints them."""
    spans.count("captures", 3)
    spans.count("evictions")
    frames = [types.SimpleNamespace(pool_bytes=3 << 20),
              types.SimpleNamespace(pool_bytes=5 << 20)]
    monkeypatch.setattr(wavefront, "cached_frames", lambda: frames)
    got = profiling.graph_cache()
    assert got == {"captures": 3, "evictions": 1, "cached": 2,
                   "pool_bytes": 8 << 20}
    rep = {"scene": "s.json", "res": [8, 8], "depth": 2, "bvh": None,
           "fallback": "packet", "mode": "masked", "frame": "compiled",
           "device": "cuda:0", "iters": 3, "frame_ms": 1.0,
           "device_profile": {"wall_ms": 2.0, "device_ms": None},
           "stage_times": {"wall_ms": 3.0, "stages": {}},
           "graph_stages": None, "graphs": got}
    text = profiling.format_report(rep)
    assert ("graphs: 3 captured, 1 dropped past the budget; 2 cached, "
            "8.0 MiB of pool") in text
    spans.reset()
    monkeypatch.setattr(wavefront, "cached_frames", lambda: [])
    assert profiling.graph_cache() == {"captures": 0, "evictions": 0,
                                       "cached": 0, "pool_bytes": 0}


def _cell_reader(name):
    from benchmark import spec
    cells = [c for c in ("cornell.offline", "cornell.interactive")
             if name in {m["name"] for m in spec.load_cell(c).per_layer}]
    return spec.reader(spec.load_cell(cells[0]), name)


SYNTHETIC = {
    "spans": [[1, "pt_setup.scene", 0.0, 0.5, None, None, False],
              [2, "pt_frame", 1.0, 3.0, None, 1, False],
              [3, "pt_frame.capture", 1.5, 2.5, 2, 1, False],
              [4, "pt_frame", 4.0, 4.004, None, 2, False],
              [5, "pt_frame", 5.0, 5.006, None, 3, False],
              [6, "pt_frame", 6.0, 6.1, None, 4, True]],
    "host_s": {"pt_setup.scene": [[0.5, False]],
               "pt_frame.warm": [[0.75, False]],
               "pt_frame.capture": [[1.0, False]],
               "pt_display.fetch": [[0.002, False], [0.004, False],
                                    [0.5, True]],
               "pt_display.u8": [[0.003, False], [0.009, True]]},
    "device_ms": {"pt_raygen": [[0.5, False], [0.7, False], [9.0, True]],
                  "pt_intersect": [[24.0, False]],
                  "pt_shade": [[3.5, False]],
                  "pt_gather": [[0.75, False]]},
    "counters": {"captures": 1, "evictions": 0}}
EXPECTED = {"stage_raygen_ms": 0.6, "stage_intersect_ms": 24.0,
            "stage_shade_ms": 3.5, "stage_gather_ms": 0.75,
            "render_host_ms": 5.0, "display_fetch_ms": 3.0,
            "display_u8_ms": 3.0, "setup_capture_s": 1.75,
            "setup_scene_s": 0.5, "graph_captures": 1}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader(name, fresh, monkeypatch):
    """Each reader: None after a CPU run (recorder full or not), None for
    a program without the recorder, and its value on a synthetic
    snapshot of a run on the card (untraced medians; render_host_ms of the
    calls that captured nothing)."""
    read = _cell_reader(name)
    scene, settings = _load("cornell", 8, 2)
    acc = zero_accum(settings, "cpu")
    wavefront.render_chunk(scene, settings, acc, 1, 1)
    to_uint8(lanes_to_image(acc, settings))
    assert read(types.SimpleNamespace(kind="cpu"), None) is None
    card = types.SimpleNamespace(kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(spans, "snapshot", lambda: SYNTHETIC)
    assert read(card, None) == pytest.approx(EXPECTED[name])
    import pathtracer_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "pathtracer_tpu_torch.utils.spans",
                        None)
    assert read(card, None) is None


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name,res,depth", [("cornell", 128, 8),
                                            ("teapot", 128, 4)])
def test_stage_sums_match_events_around_a_replay(name, res, depth, fresh):
    """The four in-graph stage times of one timed replay add up to the
    time between two events recorded outside the graph around it, less
    what runs outside the stages (the iteration's keys, its counter's
    add)."""
    _need_cuda()
    scene, settings = _load(name, res, depth, device="cuda")
    wavefront.clear_frames()
    acc = zero_accum(settings, "cuda")
    with torch.inference_mode():
        wavefront.render_chunk(scene, settings, acc, 1, 2)
        frame = wavefront.cached_frames()[-1]
        assert frame.timed is not None
        assert len(frame.events.events) == 3 * depth + 2
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)   # the graph is queued before t0
        t0.record()
        frame.replay(timed=True)
        t1.record()
        torch.cuda.synchronize()
        spans.read_replay()
    outside = t0.elapsed_time(t1)
    dev = spans.snapshot()["device_ms"]
    got = {s: dev[s][-1][0] for s in spans.TOP}
    total = sum(got.values())
    assert all(ms > 0 for ms in got.values()), got
    assert 0.9 * outside <= total <= outside, (got, outside)
    wavefront.clear_frames()


@pytest.mark.cuda
def test_images_bit_equal_with_and_without_events(fresh):
    """The compiled frame captured with a timed graph (replayed for a
    call's last iteration) and without one gives the same bits, and both
    the eager loop's."""
    _need_cuda()
    scene, settings = _load("teapot", 64, 4, device="cuda")
    wavefront.clear_frames()
    out = {}
    with torch.inference_mode():
        for on in (True, False):
            with mock.patch.object(spans, "ENABLED", on):
                acc = zero_accum(settings, "cuda")
                wavefront.render_chunk(scene, settings, acc, 1, 4)
                out[on] = _bits(acc).cpu()
        eager = wavefront.render_chunk_eager(
            scene, settings, zero_accum(settings, "cuda"), 1, 4, 0, False)
    frames = wavefront.cached_frames()
    assert len(frames) == 2
    assert frames[0].timed is not None and frames[1].timed is None
    assert frames[1].events is None
    assert torch.equal(out[True], out[False])
    assert torch.equal(out[True], _bits(eager).cpu())
    wavefront.clear_frames()
    assert set(spans.snapshot()["device_ms"]) == set(spans.TOP)
