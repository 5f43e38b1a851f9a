"""The profiling knobs ``dup_intersect`` and ``dup_fetch`` and the port's
``tools/profile_mega.py`` on the CPU (the other knobs:
``tests/test_torch_knobs.py``).

The knobs do one part of a segment's work twice and fold the second result
so that it cannot change anything: on the port's plain path the image, the
per-pixel segments and the total are those without the knob bit for bit,
and the JAX package's Pallas kernel (in interpret mode, as its own tests
run it) gives its own frame without the knob bit for bit too. Against the
JAX kernel the port is held to ``tests/test_megakernel.py``'s whole-frame
rule (over 99.5% of pixels within 1e-3, mean abs difference under 1e-3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu.kernels.megakernel import (
    render_frame_mega as j_render_frame_mega,
)
from ray_tracing_extended_tpu.models import presets as jpresets
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.ops.trace import dup_intersect
from ray_tracing_extended_tpu_torch.tools import profile_mega as pm

KNOBS = ({"dup_intersect": True}, {"dup_fetch": True})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over (each small op then waits on its
    parallel region)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tight(a, b):
    """tests/test_megakernel.py's whole-frame rule."""
    d = np.abs(a - b).max(axis=-1)
    assert (d < 1e-3).mean() > 0.995, f"frac tight {(d < 1e-3).mean()}"
    assert np.abs(a - b).mean() < 1e-3


def _scene(name, **size):
    if name == "three_sphere":
        return tpresets.three_sphere_scene(spp=2, device="cpu", **size)
    if name == "cornell":
        return tpresets.cornell_box_scene(spp=1, max_bounce=4, device="cpu",
                                          **size)
    return tpresets.mesh_scene(target_tris=4000, max_bounce=2, device="cpu",
                               **size)


@pytest.mark.parametrize("adaptive", [False, True], ids=["exact", "refill"])
@pytest.mark.parametrize("name", ["three_sphere", "cornell", "mesh"])
def test_knobs_change_nothing(name, adaptive):
    """Each knob on the plain path gives the frame without it bit for bit:
    image and total through ``render_frame_mega``, and the per-pixel
    segments and bounce histogram of a K = 2 fold through
    ``render_frames_mega``."""
    scene, cam, cfg = _scene(name, width=32, height=18)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive)
    img, total = tmk.render_frame_mega(scene, cam, cfg, 3)
    acc0 = torch.from_numpy(
        np.random.RandomState(0).rand(18, 32, 3).astype(np.float32))
    fold = tmk.render_frames_mega(scene, cam, cfg, 1, 2, accum=acc0,
                                  collect_stats=True)
    for knob in KNOBS:
        k_img, k_total = tmk.render_frame_mega(scene, cam, cfg, 3, **knob)
        assert torch.equal(k_img, img) and int(k_total) == int(total), knob
        k_fold = tmk.render_frames_mega(scene, cam, cfg, 1, 2, accum=acc0,
                                        collect_stats=True,
                                        probe=next(iter(knob)))
        for a, b in zip(k_fold, fold):
            assert torch.equal(a, b), knob


def test_dup_intersect_folds_a_second_closest_hit():
    """``dup_intersect`` calls the closest-hit function twice a segment,
    the second time from an origin with ``x + 1e-30``, and keeps the first
    call's hit record but for ``t = fmin(t, t2 + 1e30)``."""
    scene, cam, cfg = _scene("cornell", width=16, height=16)
    calls = []

    def closest(o, d, s):
        calls.append(o.clone())
        return tmk.plain_intersector(scene, cam, cfg)(o, d, s)

    o = torch.tensor([[0.0, 1.0, -3.0], [0.5, 1.0, 1e9]])
    d = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    hit = dup_intersect(closest)(o, d, scene)
    ref = closest(o, d, scene)
    assert len(calls) == 3
    assert torch.equal(calls[1][:, 1:], o[:, 1:])
    assert torch.equal(calls[1][:, 0], o[:, 0] + 1e-30)
    assert calls[1][0, 0] != 0.0 and calls[1][1, 0] == 0.5
    assert torch.equal(hit.t, ref.t) and torch.isinf(hit.t[1])
    for f in ("hit", "point", "normal", "mat_idx", "index"):
        assert torch.equal(getattr(hit, f), getattr(ref, f)), f


@pytest.mark.parametrize("preset", ["three_sphere_scene", "cornell_box_scene"])
def test_knobs_match_tpu_kernel_interpret(preset):
    """The port's plain path with each knob against the JAX package's
    Pallas kernel with the same knob, in interpret mode (32x32, 1 spp), and
    each JAX frame with a knob bit for bit its frame without."""
    make = getattr(jpresets, preset)
    js, jc, cfg = make(width=32, height=32, spp=1, max_bounce=2)
    ts, tc = (scene_from_arrays(js, device="cpu"),
              camera_from_arrays(jc, device="cpu"))
    base = np.asarray(j_render_frame_mega(js, jc, cfg, jnp.uint32(3),
                                          interpret=True)[0])
    for knob in KNOBS:
        a = np.asarray(j_render_frame_mega(js, jc, cfg, jnp.uint32(3),
                                           interpret=True, **knob)[0])
        assert np.array_equal(a, base), knob
        b = tmk.render_frame_mega(ts, tc, cfg, 3, **knob)[0].numpy()
        _tight(a, b)


def test_unported_and_conflicting_knobs_raise(monkeypatch):
    """Every knob is ported: the stubs render (their frames differ from the
    production one), two knobs at once raise but the two stubs, an unknown
    probe raises, and so does stub_intersect (alone or with stub_fetch)
    under two phases, which the JAX kernel's stub gives a result this
    kernel does not reproduce, and under the JAX package's winner fetch
    (forced here), whose result is undefined (``probe_instantiation``)."""
    scene, cam, cfg = _scene("three_sphere", width=8, height=8)
    base = tmk.render_frame_mega(scene, cam, cfg, 0)[0]
    for knob in ({"stub_fetch": True}, {"stub_intersect": True},
                 {"stub_fetch": True, "stub_intersect": True}):
        img, total = tmk.render_frame_mega(scene, cam, cfg, 0, **knob)
        assert img.shape == base.shape and int(total) > 0
        assert not torch.equal(img, base), knob
    with pytest.raises(ValueError, match="at most one"):
        tmk.render_frame_mega(scene, cam, cfg, 0, dup_intersect=True,
                              dup_fetch=True)
    with pytest.raises(ValueError, match="probe"):
        tmk.render_frames_mega(scene, cam, cfg, 0, probe="dup_shading")
    two = dataclasses.replace(cfg, mega_phases=2)
    for probe in ("stub_intersect", "stubs"):
        with pytest.raises(NotImplementedError, match="1687-1700"):
            tmk.render_frames_mega(scene, cam, two, 0, probe=probe)
    monkeypatch.setattr(tmk, "ONEHOT_MAX_SLOTS", 0)
    with pytest.raises(NotImplementedError, match="637-638"):
        tmk.render_frame_mega(scene, cam, cfg, 0, stub_intersect=True)


def test_variant_names():
    assert tmk.variant("spheres", probe="dup_intersect") == (
        "render_kernel<kSpheres, kBoxMuller, kDupIntersect>")
    assert tmk.variant("bvh", True, probe="dup_fetch") == (
        "render_adaptive<kBvh, kBoxMuller, kDupFetch>")
    assert tmk.variant("chunks", True, True, "no_cull", "global", True) == (
        "render_adaptive<kChunks, kFastScatter, kNoCull, kGlobal, kKnobs>")
    # each production instantiation under each of the five knobs
    assert len(set(tmk.PROBE_VARIANTS)) == 5 * len(
        tmk.VARIANTS + tmk.GLOBAL_VARIANTS + tmk.KNOB_VARIANTS) == 180
    assert not set(tmk.PROBE_VARIANTS) & set(tmk.VARIANTS)


def test_decompose_arithmetic():
    """intersect ~ di - full, fetch ~ df - full, other ~ 3 full - di - df,
    from the medians, each with its share of full; a delta no larger than
    full's range prints as within spread."""
    full = [10.0, 10.4, 10.2, 9.9, 10.1]  # median 10.1, range 0.5
    di = [13.0, 13.2, 13.1, 12.9, 13.1]  # median 13.1
    df = [10.3, 10.6, 10.4, 10.5, 10.2]  # median 10.4
    s = pm.decompose(full, di, df)
    assert s["full"] == dict(median=10.1, min=9.9, max=10.4)
    assert s["spread"] == pytest.approx(0.5)
    assert s["intersect"]["ms"] == pytest.approx(3.0)
    assert s["intersect"]["share"] == pytest.approx(3.0 / 10.1)
    assert not s["intersect"]["within_spread"]
    assert s["fetch"]["ms"] == pytest.approx(0.3)
    assert s["fetch"]["within_spread"]
    assert s["other"]["ms"] == pytest.approx(3 * 10.1 - 13.1 - 10.4)
    lines = pm.report(s, {"full": 7, "dup_intersect": 7, "dup_fetch": 7}, 4)
    assert lines[0].startswith("full") and "10.100 ms (9.900-10.400)" in lines[0]
    assert "segs=7 in 4 frames" in lines[2]
    assert lines[3] == ("intersect ~ 3.000 ms (30%), fetch ~ within spread, "
                        "other ~ 6.800 ms (67%)")
    # a delta below full's spread in either direction is within it
    assert pm.decompose([1.0, 2.0], [0.5, 0.5], [3.0, 3.0])["intersect"][
        "within_spread"]


def test_decompose_stubs_arithmetic():
    """The stub form from the medians: intersect ~ full - stub_intersect,
    fetch ~ full - stub_fetch, other ~ stubs, each with its share of full;
    ``report`` prints the stub variants, the stub form and what the culls
    save after the dup form."""
    full = [10.0, 10.4, 10.2]  # median 10.2
    s = pm.decompose_stubs(full, [2.0, 2.2, 2.1], [6.0, 6.2, 6.1],
                           [1.5, 1.6, 1.7])
    assert s["intersect"]["ms"] == pytest.approx(10.2 - 2.1)
    assert s["fetch"]["ms"] == pytest.approx(10.2 - 6.1)
    assert s["other"]["ms"] == pytest.approx(1.6)
    assert s["other"]["share"] == pytest.approx(1.6 / 10.2)
    split = pm.decompose(full, [13.0, 13.1, 13.2], [10.5, 10.6, 10.7])
    culls = {"no_cull": dict(median=30.0, min=29.0, max=31.0), "ms": 19.8,
             "share": 19.8 / 10.2}
    segs = {"full": 9, "dup_intersect": 9, "dup_fetch": 9,
            "stub_intersect": 7, "stub_fetch": 5, "stubs": 6, "no_cull": 9}
    lines = pm.report(split, segs, 4, s, culls)
    assert [ln.split()[0] for ln in lines] == [
        "full", "dup_intersect", "dup_fetch", "intersect", "stub_intersect",
        "stub_fetch", "stubs", "stub", "no_cull", "culls"]
    assert "segs=5 in 4 frames" in lines[5]
    assert lines[7] == ("stub form: intersect ~ 8.100 ms (79%), fetch ~ "
                        "4.100 ms (40%), other ~ 1.600 ms (16%)")
    assert lines[9] == "culls save ~ 19.800 ms (194%)"
    # under the winner fetch: stub_fetch alone, the others not run
    winner = pm.report(split, dict(segs, stub_intersect="why"), 4,
                       {"stub_fetch": s["stub_fetch"]})
    assert winner[4] == "stub_intersect not run: why"
    assert len(winner) == 7


def test_tool_rehearses_on_the_cpu(capsys):
    """``main`` with ``--device cpu`` runs the whole tool through the plain
    path and prints the header, the three variants and the split."""
    assert pm.main(["--device", "cpu", "--width", "32", "--height", "18",
                    "--spp", "1", "--max-bounce", "2", "--reps", "2",
                    "--frames", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("preset:rtiow 32x18, 1 spp, 2 bounces, exact")
    assert "the CPU: a rehearsal" in out[0]
    assert [ln.split()[0] for ln in out[1:4]] == [
        "full", "dup_intersect", "dup_fetch"]
    segs = {ln.split("segs=")[1] for ln in out[1:4]}
    assert len(segs) == 1
    assert out[4].startswith("intersect ~ ") and ", other ~ " in out[4]
    assert [ln.split()[0] for ln in out[5:11]] == [
        "stub_intersect", "stub_fetch", "stubs", "stub", "no_cull", "culls"]
    # the lane knobs paired, fast scatter, the global route: the header
    # names them
    assert pm.main(["--device", "cpu", "--width", "32", "--height", "32",
                    "--spp", "1", "--max-bounce", "1", "--reps", "2",
                    "--frames", "1", "--adaptive-spp", "--fast-scatter",
                    "--pixels-per-lane", "2", "--paired",
                    "--tables", "global"]) == 0
    head = capsys.readouterr().out.splitlines()[0]
    assert ("refill, fast scatter, 2 pixels a lane, paired, global tables"
            in head)
    with pytest.raises(SystemExit, match="--scene"):
        pm.main(["--scene", "preset:nothing", "--device", "cpu"])
    if not torch.cuda.is_available():  # the tool measures the card or nothing
        with pytest.raises(SystemExit, match="CUDA is not available"):
            pm.main([])
