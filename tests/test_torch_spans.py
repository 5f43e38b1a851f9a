"""The port's spans (``utils/profiling.py``) in a ``torch.profiler`` trace
of ``render_progressive`` on the CPU.

Each test records a call under ``profiling.trace`` and reads the Chrome
trace's ``user_annotation`` events back: which spans a frame or a chunk
opens, how they nest by time, and when a table build shows. The span names
are written out here, not taken from the module, because the benchmark's
readers match the same literal strings. Outside a profiler ``annotate``
opens nothing, and a trace changes no value the program computes.
"""

import json

import pytest
import torch

import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.parallel import sharding as sh
from ray_tracing_extended_tpu_torch.utils import checkpoint as tckpt
from ray_tracing_extended_tpu_torch.utils import profiling
from ray_tracing_extended_tpu_torch.utils.metrics import MetricsLogger


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rtiow(height=8):
    """RTIOW at 16 pixels wide: its 484 spheres make several clusters, so a
    camera has a visit order of its own (``visit_tables``)."""
    return tpresets.rtiow_final_scene(width=16, height=height, max_bounce=2,
                                      spp=1, device="cpu")


def _traced(tmp_path, fn):
    """``fn()`` under ``profiling.trace`` -> (its result, the program's
    spans as (name, start, end) sorted by start)."""
    with profiling.trace(str(tmp_path / "prof")):
        out = fn()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"] in profiling.SPANS]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(spans, outer):
    """The spans whose interval lies within ``outer``'s, but for itself."""
    _, lo, hi = outer
    return [s for s in spans if s is not outer and lo <= s[1] and s[2] <= hi]


def test_a_frame_opens_its_spans_in_order(tmp_path):
    """Batch 1 with a metrics logger: a ``driver.step`` a frame, holding
    one launch (with its tables lookup), fold, wait, read-back and line,
    one after the other."""
    scene, cam, cfg = _rtiow()
    _, spans = _traced(tmp_path, lambda: rtt.render_progressive(
        scene, cam, cfg, frames=3, metrics=MetricsLogger()))
    steps = _named(spans, "driver.step")
    assert len(steps) == 3
    order = ["wrapper.launch", "driver.fold", "driver.wait", "driver.stats",
             "driver.log"]
    for step in steps:
        inner = _inside(spans, step)
        assert [s[0] for s in inner if s[0] in order] == order
        launch = _named(inner, "wrapper.launch")[0]
        assert [s[0] for s in _inside(inner, launch)
                if s[0] == "wrapper.tables"] == ["wrapper.tables"]
        ends = [_named(inner, n)[0] for n in order]
        assert all(a[2] <= b[1] for a, b in zip(ends, ends[1:]))
    # nothing of a frame lies outside its step
    assert sum(len(_inside(spans, s)) for s in steps) == len(spans) - 3


def test_a_chunk_is_one_step_without_fold_or_stats(tmp_path):
    """Batch > 1: a ``driver.step`` a chunk, holding its launch, wait and
    line; the fold is inside the launch and no histogram is read back."""
    scene, cam, cfg = _rtiow()
    _, spans = _traced(tmp_path, lambda: rtt.render_progressive(
        scene, cam, cfg, frames=5, batch=2, metrics=MetricsLogger()))
    steps = _named(spans, "driver.step")
    assert len(steps) == 3
    for step in steps:
        names = [s[0] for s in _inside(spans, step)]
        for name in ("wrapper.launch", "driver.wait", "driver.log"):
            assert names.count(name) == 1, name
    assert not _named(spans, "driver.fold")
    assert not _named(spans, "driver.stats")


def test_resume_opens_one_resume_span(tmp_path):
    """``resume=True`` opens one ``driver.resume`` before the first step;
    the last checkpoint is a ``driver.checkpoint`` after the last step."""
    scene, cam, cfg = _rtiow()
    path = str(tmp_path / "ckpt.npz")
    rtt.render_progressive(scene, cam, cfg, frames=1, checkpoint_path=path)
    _, spans = _traced(tmp_path, lambda: rtt.render_progressive(
        scene, cam, cfg, frames=2, checkpoint_path=path, resume=True))
    resume = _named(spans, "driver.resume")
    steps = _named(spans, "driver.step")
    assert len(resume) == 1 and len(steps) == 2
    assert resume[0][2] <= steps[0][1]
    saves = _named(spans, "driver.checkpoint")
    assert len(saves) == 1 and saves[0][1] >= steps[-1][2]
    assert tckpt.load(path, tckpt.state_hash(scene, cam, cfg))[1] == 3


def test_tables_build_once_a_scene_and_camera(tmp_path):
    """A fresh scene's first call builds its tables and its camera's visit
    order once, inside the first launch; a second call on the same scene
    and still camera builds neither."""
    scene, cam, cfg = _rtiow()
    _, first = _traced(tmp_path / "a", lambda: rtt.render_progressive(
        scene, cam, cfg, frames=2))
    builds = _named(first, "wrapper.table_build")
    visits = _named(first, "wrapper.visit_build")
    assert len(builds) == 1 and len(visits) == 1
    launch = _named(first, "wrapper.launch")[0]
    assert builds[0] in _inside(first, launch)
    assert visits[0] in _inside(first, launch)
    _, second = _traced(tmp_path / "b", lambda: rtt.render_progressive(
        scene, cam, cfg, frames=2))
    assert not _named(second, "wrapper.table_build")
    assert not _named(second, "wrapper.visit_build")
    assert len(_named(second, "wrapper.tables")) == 2


def test_a_moved_camera_builds_its_visit_order_once(tmp_path):
    """A camera whose position is another tensor gets its visit order built
    once, over all its frames; the scene's tables are not rebuilt."""
    scene, cam, cfg = _rtiow()
    rtt.render_progressive(scene, cam, cfg, frames=1)
    moved = cam.replace(position=cam.position + torch.tensor([0.0, 0.5, 0.0]))
    _, spans = _traced(tmp_path, lambda: rtt.render_progressive(
        scene, moved, cfg, frames=3))
    assert len(_named(spans, "wrapper.visit_build")) == 1
    assert not _named(spans, "wrapper.table_build")


def test_a_mesh_step_launches_once_a_band(tmp_path):
    """On a two-band mesh each step is a ``driver.step`` holding a
    ``wrapper.launch`` a band, then one fold and one wait."""
    scene, cam, cfg = _rtiow(height=16)  # two bands of 8 rows
    mesh = sh.make_mesh(["cpu"] * 2, spp_parallel=1)
    _, spans = _traced(tmp_path, lambda: rtt.render_progressive(
        scene, cam, cfg, frames=2, mesh=mesh, metrics=MetricsLogger()))
    steps = _named(spans, "driver.step")
    assert len(steps) == 2
    for step in steps:
        names = [s[0] for s in _inside(spans, step)]
        assert names.count("wrapper.launch") == 2
        for name in ("driver.fold", "driver.wait", "driver.log"):
            assert names.count(name) == 1, name


def test_annotate_opens_nothing_without_a_profiler(monkeypatch):
    """Outside a profiler ``annotate`` returns the shared no-op and a whole
    call opens no ``record_function``; inside one it opens a span."""
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("driver.step") is profiling.NO_SPAN
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    scene, cam, cfg = _rtiow()
    rtt.render_progressive(scene, cam, cfg, frames=2,
                           metrics=MetricsLogger())
    assert opened == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("driver.step"):
            pass
    assert opened == ["driver.step"]


@pytest.mark.parametrize("batch", [1, 2])
def test_a_trace_changes_no_value(tmp_path, batch):
    """The image is the same bit for bit with and without the trace."""
    scene, cam, cfg = _rtiow()
    plain = rtt.render_progressive(scene, cam, cfg, frames=4, batch=batch,
                                   metrics=MetricsLogger())
    traced, spans = _traced(tmp_path, lambda: rtt.render_progressive(
        scene, cam, cfg, frames=4, batch=batch, metrics=MetricsLogger()))
    assert spans and torch.equal(plain, traced)


def test_span_names_are_the_modules_constants():
    """Every span is named ``<layer>.<part>`` once; refill's launches on
    the card are told apart by three of them, and the benchmark's readers
    match three more."""
    names = profiling.SPANS
    assert len(set(names)) == len(names)
    assert all(len(n.split(".")) == 2 for n in names)
    for name in ("refill.phase1", "refill.lane_pass", "refill.phase2",
                 "wrapper.launch", "driver.stats", "driver.wait"):
        assert name in names
    assert (profiling.REFILL_PHASE1, profiling.REFILL_LANE_PASS,
            profiling.REFILL_PHASE2) == (
        "refill.phase1", "refill.lane_pass", "refill.phase2")
