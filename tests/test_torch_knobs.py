"""The TPU kernel's last profiling knobs in the port: ``stub_intersect``,
``stub_fetch`` and ``use_cull=False``, and the rest of the JAX package's
``render_frame_mega`` arguments, on the CPU.

Against the JAX package's Pallas kernel in interpret mode (as its own
tests run it) the port's plain version is held to
``tests/test_megakernel.py``'s whole-frame rule (over 99.5% of pixels
within 1e-3, mean abs difference under 1e-3) with equal segment totals: a
stub replaces the winner's fields by one row of values (``stub_row``), and
the port shades from them by the TPU kernel's own forms (``stub_surface``),
so the two differ only where the ordinary kernel and the port do.
``use_cull=False`` (``no_cull``) must give the culled frame bit for bit,
and ``stub_fetch`` under the JAX package's winner fetch the production
frame; ``stub_intersect`` there raises.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu.kernels import pack as j_pack
from ray_tracing_extended_tpu.kernels.megakernel import (
    render_frame_mega as j_render_frame_mega,
)
from ray_tracing_extended_tpu.models import presets as jpresets
from ray_tracing_extended_tpu.scene.json_scene import load_json_scene as j_load
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.kernels import pack as t_pack
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.models.wide_scenes import (
    wide_sphere_builder,
)

KNIGHT = str(pathlib.Path(__file__).resolve().parent.parent / "scenes"
             / "knight.json")
# the knob settings of the JAX function, and the port's name for each
SETTINGS = {
    "stub_intersect": dict(stub_intersect=True),
    "stub_fetch": dict(stub_fetch=True),
    "no_cull": dict(use_cull=False),
    "stubs": dict(stub_intersect=True, stub_fetch=True),
}


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


def _jax_scene(name, **size):
    """A JAX-package scene (spheres only; Cornell, emissive triangles in
    chunks; the Knight mirror, emissive, checkered, vertex-normal triangles
    in chunks) -> (JAX scene, camera, config)."""
    if name == "knight":
        return j_load(KNIGHT, overrides=dict(size))
    make = {"three_sphere": jpresets.three_sphere_scene,
            "cornell": jpresets.cornell_box_scene}[name]
    return make(**size)


def _both(name, **size):
    js, jc, cfg = _jax_scene(name, **size)
    cfg = dataclasses.replace(cfg, mega_tile_size=32)
    return (js, jc, cfg, scene_from_arrays(js, device="cpu"),
            camera_from_arrays(jc, device="cpu"))


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("name", ["three_sphere", "cornell", "knight"])
def test_knob_matches_tpu_kernel_interpret(name, setting):
    """The port's plain path under each knob against the JAX package's
    Pallas kernel under it (32x32, 1 spp, 2 bounces, tiles of 32): the
    whole-frame rule and equal segment totals."""
    js, jc, cfg, ts, tc = _both(name, width=32, height=32, spp=1,
                                max_bounce=2)
    knob = SETTINGS[setting]
    a, a_segs = j_render_frame_mega(js, jc, cfg, jnp.uint32(3),
                                    interpret=True, **knob)
    b, b_segs = tmk.render_frame_mega(ts, tc, cfg, 3, **knob)
    _tight(np.asarray(a), b.numpy())
    assert int(a_segs) == int(b_segs)


def _frame(scene, cam, cfg, probe=None):
    return tmk.render_frames_plain(scene, cam, cfg, 3, collect_stats=True,
                                   probe=probe)


def _port_scene(name):
    if name == "three_sphere":
        return tpresets.three_sphere_scene(width=24, height=16, spp=2,
                                           device="cpu")
    if name == "cornell":
        return tpresets.cornell_box_scene(width=16, height=16, spp=1,
                                          max_bounce=4, device="cpu")
    if name == "mesh":
        return tpresets.mesh_scene(width=16, height=16, max_bounce=2,
                                   target_tris=1000, device="cpu")
    # RTIOW's rule over 40 x 40 cells: 1,604 spheres, supers over its
    # clusters
    b = wide_sphere_builder(tpresets, 20)
    scene = b.build(device="cpu")
    _, cam, cfg = tpresets.rtiow_final_scene(width=16, height=16, spp=1,
                                             max_bounce=3, device="cpu")
    return scene, cam, cfg


@pytest.mark.parametrize("adaptive", [False, True], ids=["exact", "refill"])
@pytest.mark.parametrize("name", ["three_sphere", "cornell", "mesh", "wide"])
def test_no_cull_is_the_culled_frame(name, adaptive):
    """``no_cull`` (every gate open: the sphere clusters and their supers,
    the chunks, and through the BVH every triangle) gives the culled
    frame's image, per-pixel segments, total and histogram bit for bit:
    either scan keeps the lexicographic minimum of (t, index)."""
    scene, cam, cfg = _port_scene(name)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive, mega_tile_size=16)
    if name == "wide":
        assert tmk.geometry_tables(scene, "spheres").sph_supers is not None
    if name == "mesh":
        assert tmk.geometry(scene, cfg) == "bvh"
    ref = _frame(scene, cam, cfg)
    out = _frame(scene, cam, cfg, "no_cull")
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_no_cull_counts_every_test():
    """The scan without culls counts every real sphere and triangle a
    segment and no box; through the BVH every triangle row."""
    scene, cam, cfg = _port_scene("cornell")
    counts = {}
    fn = tmk.plain_intersector(scene, cam, cfg, counts, cull=False)
    tmk.render_frames_plain(scene, cam, cfg, 3, intersect_fn=fn)
    n = counts["segments"]
    real = int((scene.spheres.radius > 0).sum())
    assert counts["sphere_tests"] == n * real
    assert counts["triangle_tests"] == n * int(scene.chunks.num_tris.sum())
    assert "cluster_slabs" not in counts and "chunk_slabs" not in counts
    with pytest.raises(ValueError, match="no intersect_fn"):
        tmk.render_frames_plain(scene, cam, cfg, 3, intersect_fn=fn,
                                probe="no_cull")


@pytest.mark.parametrize("name", ["three_sphere", "cornell"])
def test_stub_fetch_under_winner_fetch_is_the_production_frame(name,
                                                              monkeypatch):
    """Under the winner fetch (forced: more than ``ONEHOT_MAX_SLOTS`` table
    slots, the threshold patched down in both packages, as the JAX
    package's own tests force it) the TPU kernel's stub_fetch returns
    before its stub: its frame is the production one, in both packages.
    stub_intersect there has no defined result and the port raises."""
    monkeypatch.setattr(j_pack, "ONEHOT_MAX_SLOTS", 0)
    monkeypatch.setattr(tmk, "ONEHOT_MAX_SLOTS", 0)
    js, jc, cfg, ts, tc = _both(name, width=32, height=32, spp=1,
                                max_bounce=2)
    assert js.packed.fetch_mode == "winner" and tmk.winner_fetch(ts)
    a = np.asarray(j_render_frame_mega(js, jc, cfg, jnp.uint32(3),
                                       interpret=True)[0])
    a_stub = np.asarray(j_render_frame_mega(js, jc, cfg, jnp.uint32(3),
                                            interpret=True,
                                            stub_fetch=True)[0])
    np.testing.assert_array_equal(a_stub, a)
    ref = _frame(ts, tc, cfg)
    for a_, b_ in zip(_frame(ts, tc, cfg, "stub_fetch"), ref):
        assert torch.equal(a_, b_)
    assert tmk.probe_instantiation(ts, "stub_fetch", cfg) is None
    for probe in ("stub_intersect", "stubs"):
        with pytest.raises(NotImplementedError, match="637-638"):
            _frame(ts, tc, cfg, probe)
    with pytest.raises(NotImplementedError, match="winner fetch"):
        tmk.render_frame_mega(ts, tc, cfg, 3, stub_intersect=True)


@pytest.mark.parametrize("name", ["three_sphere", "cornell", "knight",
                                  "wide_rule_16"])
def test_stub_row_is_the_tpu_fetch(name):
    """``stub_row`` holds what the TPU kernel's fetch gives a winner under
    each stub: the scene's fetch fields (``kernels/pack.fetch_fields``, the
    JAX ``PackedScene.fetch_fields``), stub_fetch's constant by each
    field's place, and under stub_intersect alone the JAX one-hot fetch
    table's slot 0 (its column 0 of ``fetch_tab``). ``wide_rule_16``:
    RTIOW's rule over 32 x 32 cells, 1,028 spheres, where the JAX package
    drops the hoist and the port keeps it."""
    if name == "wide_rule_16":
        js = wide_sphere_builder(jpresets, 16).build()
        ts = scene_from_arrays(js, device="cpu")
        assert ts.spheres.count >= 1028
    else:
        js, _, _, ts, _ = _both(name, width=8, height=8, spp=1)
    packed = js.packed
    mats, tri = ts.materials, ts.triangles
    feats = t_pack.scene_features(
        mats.flag.numpy(), mats.emission_strength.numpy(), tri.n.numpy(),
        tri.normal_a.numpy(), tri.normal_b.numpy(), tri.normal_c.numpy())
    assert set(feats) == set(packed.features) - {"env", "sun"}
    assert t_pack.fetch_fields(feats) == tuple(packed.fetch_fields)
    assert tmk.tpu_table_slots(ts) == packed.fetch_tab.shape[1]

    const = tmk.stub_row(ts, "stub_fetch")
    assert np.array_equal(const, tmk.stub_row(ts, "stubs"))
    m = tmk.STUB_MAT
    value = {f: np.float32(0.1 + 0.01 * i)
             for i, f in enumerate(packed.fetch_fields)}
    assert const[3] == value["sr2"] and const[m + 11] == value["sprob"]
    assert const[25] == (value["is_sph"] if "tris" in feats else 1.0)
    if "emissive" in feats:
        assert const[m + 9] == value["estr"]

    # JAX fetch table rows: colour 0-2, emission 3-5, specular 6-8,
    # strength 9, smoothness 10, specular probability 11, flag 12, ior 13,
    # is_sphere 14, centre 15-17, r^2 39
    slot0 = np.asarray(packed.fetch_tab)[:, 0]
    row = tmk.stub_row(ts, "stub_intersect")
    np.testing.assert_array_equal(row[0:3], slot0[15:18])
    assert row[3] == slot0[39] and row[25] == slot0[14] == 1.0
    mat = row[m:]
    np.testing.assert_array_equal(mat[0:9], slot0[0:9])
    np.testing.assert_array_equal(mat[10:13], [slot0[10], slot0[11],
                                               slot0[13]])
    assert mat[9] == (slot0[9] if "emissive" in feats else 0.0)
    flagged = {"checker", "invisible", "dielectric"} & set(feats)
    assert mat[13] == (slot0[12] if flagged else 0.0)


def test_stub_intersect_on_a_scene_without_spheres():
    """A scene without a real sphere: slot 0 of the JAX tables is a padding
    slot (centre 0, radius -1: r^2 1), and its frame matches the JAX
    kernel's."""
    b = jpresets.SceneBuilder(env=jpresets._gradient_sky())
    verts = np.array([[-1, 0, -1], [1, 0, -1], [0, 1.5, 0.5]], np.float32)
    b.add_mesh(verts, np.array([[0, 2, 1]]),
               jpresets.Material.lambertian((0.7, 0.3, 0.2)))
    js = b.build()
    jc = jpresets.look_at((0.0, 0.7, -4.0), (0.0, 0.5, 0.0), fov_y_deg=40.0,
                          focus_distance=4.0, defocus_strength=0.0)
    cfg = jpresets.RenderConfig(width=16, height=16, spp=1, max_bounce=2,
                                mega_tile_size=16)
    ts, tc = scene_from_arrays(js, device="cpu"), camera_from_arrays(
        jc, device="cpu")
    assert tmk.tpu_slot_zero(ts) is None
    row = tmk.stub_row(ts, "stub_intersect")
    assert np.array_equal(row[0:4], [0.0, 0.0, 0.0, 1.0])
    a, a_segs = j_render_frame_mega(js, jc, cfg, jnp.uint32(1),
                                    interpret=True, stub_intersect=True)
    b_img, b_segs = tmk.render_frame_mega(ts, tc, cfg, 1,
                                          stub_intersect=True)
    _tight(np.asarray(a), b_img.numpy())
    assert int(a_segs) == int(b_segs)


def test_probe_settings():
    """The JAX function's knobs -> the port's setting: one knob, or the two
    stubs together; use_cull=False beside stub_intersect changes nothing;
    any other pair raises."""
    assert tmk.probe_setting() is None
    assert tmk.probe_setting(use_cull=False) == "no_cull"
    assert tmk.probe_setting(stub_fetch=True, stub_intersect=True) == "stubs"
    assert tmk.probe_setting(use_cull=False,
                             stub_intersect=True) == "stub_intersect"
    for bad in (dict(dup_intersect=True, dup_fetch=True),
                dict(use_cull=False, dup_fetch=True),
                dict(stub_fetch=True, dup_intersect=True)):
        with pytest.raises(ValueError, match="at most one"):
            tmk.probe_setting(**bad)


def test_render_frame_mega_arguments():
    """The JAX function's band, stats and segment-map arguments: a band of
    rows is those rows of the frame bit for bit, rows past the frame
    repeat its last (the TPU kernel's edge tiles re-render their clamped
    border pixel) and count in the map but not the total; ``counts`` is
    (hist_rows,) with the histogram in rows [0, max_bounce] and zeros
    above, of the JAX function's length; ``segs_map`` the per-pixel map."""
    js, jc, cfg, ts, tc = _both("three_sphere", width=16, height=24, spp=1,
                                max_bounce=2)
    img, total, counts = tmk.render_frame_mega(ts, tc, cfg, 2,
                                               collect_stats=True)
    _, _, seg_map, hist = tmk.render_frames_mega(ts, tc, cfg, 2,
                                                 collect_stats=True)
    j_counts = np.asarray(j_render_frame_mega(
        js, jc, cfg, jnp.uint32(2), interpret=True, collect_stats=True)[2])
    assert counts.shape == j_counts.shape == (8,)
    assert counts.dtype == torch.int32
    assert torch.equal(counts[:3], hist) and not counts[3:].any()
    assert int(counts[0]) == 16 * 24
    _, total2, m = tmk.render_frame_mega(ts, tc, cfg, 2, segs_map=True)
    assert torch.equal(m, seg_map) and int(total2) == int(total)

    band, band_total, band_map = tmk.render_frame_mega(
        ts, tc, cfg, 2, y0=8, band_height=8, segs_map=True)
    assert torch.equal(band, img[8:16]) and torch.equal(band_map,
                                                        seg_map[8:16])
    # the plain exact path's total counts its last block's padding lanes
    # (render_frames_plain): the band's own call's
    assert int(band_total) == int(tmk.render_frames_mega(
        ts, tc, cfg, 2, rows=(8, 16))[1])
    past, past_total, past_map = tmk.render_frame_mega(
        ts, tc, cfg, 2, y0=16, band_height=16, segs_map=True)
    assert past.shape == (16, 16, 3) and past_map.shape == (16, 16)
    assert torch.equal(past[:8], img[16:]) and torch.equal(
        past[8:], img[23:24].expand(8, -1, -1))
    assert torch.equal(past_map[8:], seg_map[23:24].expand(8, -1))
    assert int(past_total) == int(tmk.render_frames_mega(
        ts, tc, cfg, 2, rows=(16, 24))[1])
    with pytest.raises(ValueError, match="band"):
        tmk.render_frame_mega(ts, tc, cfg, 2, y0=24)


@pytest.mark.parametrize("adaptive", [False, True], ids=["exact", "refill"])
def test_rowdrain_leaves_the_plain_image(adaptive):
    """``mega_rowdrain`` is a TPU mechanism (the JAX kernel's row drain of
    culled sub-clusters, which leaves its image as it is): the port takes
    the config and its plain image, maps and histogram do not move."""
    scene, cam, cfg = _port_scene("cornell")
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive, mega_tile_size=16)
    ref = _frame(scene, cam, cfg)
    for drain in (True, False):
        out = _frame(scene, cam, dataclasses.replace(cfg, mega_rowdrain=drain))
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


def _emissive_slot_zero():
    """A two-sphere JAX scene whose first sphere (the JAX tables' slot 0)
    emits light, so a stub_intersect frame is not black: 16x16, 1 spp, 3
    bounces, tiles of 16."""
    b = jpresets.SceneBuilder(env=jpresets._gradient_sky())
    b.add_sphere((0.0, 1.0, 0.0), 1.0, jpresets.Material(
        colour=(0.7, 0.6, 0.5), emission_colour=(1.0, 0.8, 0.6),
        emission_strength=2.0, specular_probability=0.0))
    b.add_sphere((2.0, 0.5, 0.0), 0.5,
                 jpresets.Material.lambertian((0.2, 0.6, 0.5)))
    js = b.build()
    jc = jpresets.look_at((0.0, 1.0, -5.0), (0.0, 0.8, 0.0), fov_y_deg=40.0,
                          focus_distance=5.0, defocus_strength=0.0)
    cfg = jpresets.RenderConfig(width=16, height=16, spp=1, max_bounce=3,
                                mega_tile_size=16)
    return (js, jc, cfg, scene_from_arrays(js, device="cpu"),
            camera_from_arrays(jc, device="cpu"))


@pytest.mark.parametrize("adaptive", [False, True], ids=["exact", "refill"])
def test_stub_intersect_under_two_phases_raises(adaptive):
    """stub_intersect on an emissive slot 0: with one phase the port's
    plain frame matches the JAX kernel's in interpret mode (the
    whole-frame rule, equal segment totals, a lit frame). With two phases
    the JAX kernel's stub also hits the lanes waiting for their phase and
    its segment body moves them (``megakernel.py:1556``, ``:1687-1700``):
    in exact spp, where two phases leave its frame without the stub within
    1e-6, its stub frame moves by a mean of over 0.1 (1.6 on this frame).
    The port raises there, exact or refill, for the stub alone and for
    both stubs, and renders stub_fetch."""
    js, jc, cfg, ts, tc = _emissive_slot_zero()
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive)
    two = dataclasses.replace(cfg, mega_phases=2)

    def jax_frame(c, **knob):
        return j_render_frame_mega(js, jc, c, jnp.uint32(3), interpret=True,
                                   **knob)

    a, a_segs = jax_frame(cfg, stub_intersect=True)
    b, b_segs = tmk.render_frame_mega(ts, tc, cfg, 3, stub_intersect=True)
    a = np.asarray(a)
    assert a.mean() > 0.1
    _tight(a, b.numpy())
    assert int(a_segs) == int(b_segs)
    if not adaptive:
        plain_moved = np.abs(np.asarray(jax_frame(two)[0])
                             - np.asarray(jax_frame(cfg)[0])).max()
        assert plain_moved < 1e-6
        stub_two = np.asarray(jax_frame(two, stub_intersect=True)[0])
        assert np.abs(stub_two - a).mean() > 0.1
    for knob in (dict(stub_intersect=True),
                 dict(stub_intersect=True, stub_fetch=True)):
        with pytest.raises(NotImplementedError, match="1556"):
            tmk.render_frame_mega(ts, tc, two, 3, **knob)
    img, total = tmk.render_frame_mega(ts, tc, two, 3, stub_fetch=True)
    assert torch.isfinite(img).all() and int(total) > 0
