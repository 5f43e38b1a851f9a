"""Adaptive sample refill and the fast scatter sampler: the port's plain
version on the CPU against the TPU kernel they come from, run in interpret
mode as the JAX package's own tests run it, and the refill's invariants.

Refill makes the image depend on how pixels are grouped. Both kernels
group by the TPU kernel's TS x TS tiles (``tile_groups`` of
``refill_tile_size``, the port's copy of the JAX package's tile-size
rule), and the plain version runs the CUDA kernel's two phases
(``_refill_two_phase``), held here bit for bit to the slot machine over
the same groups. Against the JAX kernel TS is 32, as
``tests/conftest.py`` pins it there, through ``mega_tile_size`` on the
port's side. Rule for the comparisons with JAX:
``tests/test_megakernel.py``'s whole-frame rule (over 99.5% of pixels
within 1e-3, mean abs difference under 1e-3) holds for refill too, and the
segment totals are held within 1%. The rule could fail where one path
flipped by the JAX kernel's 1-ulp u32 -> f32 conversion changes the
slowest lane of a tile, and with it every pixel's extra samples there; at
these sizes it does not.
"""

import dataclasses
import os
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ray_tracing_extended_tpu.kernels.megakernel import (
    render_frame_mega,
    render_frames_mega,
    tile_size,
)
from ray_tracing_extended_tpu.kernels.pack import pack_scene
from ray_tracing_extended_tpu.models import presets as jpresets
from ray_tracing_extended_tpu.ops import rng as jrng
from ray_tracing_extended_tpu.scene.json_scene import (
    load_json_scene as j_load_json_scene,
)
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.models.wide_scenes import wide_sphere_scene
from ray_tracing_extended_tpu_torch.ops import rng as trng

TS = int(os.environ.get("RTX_MEGA_TS", "32"))
SCENES = pathlib.Path(__file__).resolve().parent.parent / "scenes"


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


def _port(j_scene, j_cam):
    return (scene_from_arrays(j_scene, device="cpu"),
            camera_from_arrays(j_cam, device="cpu"))


def _tight(a, b):
    """tests/test_megakernel.py's whole-frame rule."""
    d = np.abs(a - b).max(axis=-1)
    assert (d < 1e-3).mean() > 0.995, f"frac tight {(d < 1e-3).mean()}"
    assert np.abs(a - b).mean() < 1e-3


def test_fast_direction_sampler_matches_formula():
    """Two draws, exactly; the values are the (z, phi) map of those draws
    with the TPU kernel's constants, within an ulp of cos/sin/sqrt."""
    s = np.random.RandomState(0).randint(0, 2**32, 4096, dtype=np.uint64)
    s = s.astype(np.uint32)
    t_state, v = trng.random_direction_fast(torch.from_numpy(s.astype(np.int64)))
    j_state, u = jrng.random_value(jnp.asarray(s))
    j_state, w = jrng.random_value(j_state)
    np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state))
    u, w = np.asarray(u, np.float64), np.asarray(w, np.float64)
    z = np.float32(u * 2.0 - 1.0).astype(np.float64)
    phi = w * np.float64(np.float32(2.0 * 3.14159265))
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    want = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
    np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.linalg.norm(v.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_fast_scatter_matches_tpu_kernel_interpret():
    js, jc, cfg = jpresets.three_sphere_scene(width=32, height=32, spp=1,
                                              max_bounce=2)
    cfg = dataclasses.replace(cfg, fast_scatter=True)
    a, _ = render_frame_mega(js, jc, cfg, jnp.uint32(3), interpret=True)
    b = rtt.render_frame(*_port(js, jc), cfg, 3).numpy()
    _tight(np.asarray(a), b)
    box = rtt.render_frame(*_port(js, jc), dataclasses.replace(
        cfg, fast_scatter=False), 3).numpy()
    assert not np.array_equal(b, box)  # other draws, the same estimator


@pytest.mark.parametrize("preset", ["three_sphere_scene", "cornell_box_scene"])
def test_refill_matches_tpu_kernel_interpret(preset):
    """One frame of refill, grouped as the TPU kernel's tiles."""
    js, jc, cfg = getattr(jpresets, preset)(width=64, height=32, spp=4,
                                            max_bounce=4)
    cfg = dataclasses.replace(cfg, adaptive_spp=True)
    a, a_segs = render_frame_mega(js, jc, cfg, jnp.uint32(0), interpret=True)
    b, b_segs, _, _ = tmk.render_frames_plain(
        *_port(js, jc), cfg, 0, groups=tmk.tile_groups(64, 32, TS))
    _tight(np.asarray(a), b.numpy())
    assert abs(int(b_segs) - int(a_segs)) <= 0.01 * int(a_segs)


def test_refill_k_frames_matches_tpu_kernel_interpret():
    """Two frames in one launch from a seeded accumulator: the first frame
    folds after spp samples, the extras continue the second."""
    js, jc, cfg = jpresets.three_sphere_scene(width=64, height=32, spp=4)
    cfg = dataclasses.replace(cfg, adaptive_spp=True)
    acc0 = np.random.RandomState(0).uniform(0, 1.5, (32, 64, 3)).astype(np.float32)
    a, a_segs = render_frames_mega(js, jc, cfg, jnp.uint32(2),
                                   jnp.asarray(acc0), 2, interpret=True)[:2]
    b, b_segs, _, _ = tmk.render_frames_plain(
        *_port(js, jc), cfg, 2, 2, accum=torch.from_numpy(acc0),
        groups=tmk.tile_groups(64, 32, TS))
    _tight(np.asarray(a), b.numpy())
    assert abs(int(b_segs) - int(a_segs)) <= 0.01 * int(a_segs)


@pytest.mark.parametrize("preset", ["three_sphere_scene", "cornell_box_scene"])
def test_refill_default_grouping_matches_tpu_kernel_interpret(preset):
    """The port's refill with its own grouping, no ``groups`` given,
    against the JAX kernel, both at TS = 32 (the config's tile size on
    the port's side): one frame, and two frames folded into a seeded
    accumulator, the whole-frame rule and segment totals within 1%. (While
    the port grouped refill by warps it failed here.)"""
    js, jc, cfg = getattr(jpresets, preset)(width=64, height=32, spp=4,
                                            max_bounce=4)
    cfg = dataclasses.replace(cfg, adaptive_spp=True)
    tcfg = dataclasses.replace(cfg, mega_tile_size=TS)
    scene, cam = _port(js, jc)
    assert tmk.refill_tile_size(scene, tcfg) == TS
    a, a_segs = render_frame_mega(js, jc, cfg, jnp.uint32(0), interpret=True)
    b, b_segs = rtt.render_frame_with_stats(scene, cam, tcfg, 0)
    _tight(np.asarray(a), b.numpy())
    assert abs(int(b_segs) - int(a_segs)) <= 0.01 * int(a_segs)
    acc0 = np.random.RandomState(3).uniform(0, 1.5, (32, 64, 3)).astype(
        np.float32)
    a, a_segs = render_frames_mega(js, jc, cfg, jnp.uint32(2),
                                   jnp.asarray(acc0), 2, interpret=True)[:2]
    b, b_segs = rtt.render_frames_and_accumulate(
        scene, cam, tcfg, torch.from_numpy(acc0), 2, 2)
    _tight(np.asarray(a), b.numpy())
    assert abs(int(b_segs) - int(a_segs)) <= 0.01 * int(a_segs)


def _j_scene(name):
    """A JAX-package scene by name: a shipped mirror, a preset, or RTIOW's
    rule over a wider grid."""
    if name.endswith(".json"):
        return j_load_json_scene(SCENES / name)[0]
    if name.startswith("wide"):
        return wide_sphere_scene(jpresets, int(name[4:]), width=8,
                                 height=8)[0]
    return getattr(jpresets, name)()[0]


# every shipped scene, RTIOW and the 70k-triangle mesh; RTIOW's rule over
# 90 x 90 cells (8,103 spheres: the JAX package drops the hoist, 8,192
# slots, just within the one-hot limit) and 120 x 120 (past it)
TILE_SCENES = sorted(p.name for p in SCENES.glob("*.json")) + [
    "rtiow_final_scene", "mesh_scene", "wide45", "wide60"]


@pytest.mark.parametrize("name", TILE_SCENES)
def test_refill_tile_size_matches_jax(name, monkeypatch):
    """The port's refill tile side against the JAX package's
    ``tile_size(pack_scene(scene), adaptive=True)`` on the same arrays,
    with ``RTX_MEGA_TS`` (which the port does not read) unset; the config's
    ``mega_tile_size`` wins on both sides."""
    monkeypatch.delenv("RTX_MEGA_TS", raising=False)
    js = _j_scene(name)
    packed = pack_scene(js)
    scene = scene_from_arrays(js, device="cpu")
    cfg = tpresets.RenderConfig()
    want = tile_size(packed, adaptive=True)
    assert tmk.refill_tile_size(scene, cfg) == want
    assert want == (64 if packed.fetch_mode == "winner" else 128)
    assert (tmk.tpu_table_slots(scene) > tmk.ONEHOT_MAX_SLOTS) == (
        packed.fetch_mode == "winner")
    cfg48 = dataclasses.replace(cfg, mega_tile_size=48)
    assert tmk.refill_tile_size(scene, cfg48) == 48 == tile_size(
        packed, adaptive=True, override=48)
    with pytest.raises(ValueError, match="mega_tile_size"):
        tmk.refill_tile_size(scene,
                             dataclasses.replace(cfg, mega_tile_size=40))


def _three_sphere(**kw):
    return tpresets.three_sphere_scene(device="cpu", **kw)


def _two_phase_case(preset, width, height, spp, max_bounce):
    """A refill case on pixel blocks of 256 (``block_size``): both forms
    then trace their live lanes in several calls a slot."""
    scene, cam, cfg = getattr(tpresets, preset)(
        width=width, height=height, spp=spp, max_bounce=max_bounce,
        device="cpu")
    return scene, cam, dataclasses.replace(cfg, adaptive_spp=True,
                                           block_size=256)


@pytest.mark.parametrize("preset, n_frames, clamp, rows, ts, ppl, phases, paired", [
    ("three_sphere_scene", 1, True, None, 16, 1, 1, False),
    ("three_sphere_scene", 4, False, None, 16, 1, 1, False),
    ("three_sphere_scene", 4, True, (16, 24), 16, 1, 1, False),
    ("cornell_box_scene", 1, False, (0, 16), 16, 1, 1, False),
    ("cornell_box_scene", 4, True, None, 32, 1, 1, False),
    ("three_sphere_scene", 1, True, None, 16, 2, 1, False),
    ("three_sphere_scene", 4, False, (16, 24), 16, 2, 2, True),
    ("three_sphere_scene", 1, True, None, 32, 4, 1, False),
    ("cornell_box_scene", 4, True, None, 16, 1, 2, False),
    ("cornell_box_scene", 1, False, (0, 16), 16, 2, 2, False),
    ("cornell_box_scene", 4, True, None, 32, 2, 1, True),
], ids=["k1", "k4-hdr", "k4-band", "cornell-k1-band", "cornell-k4",
        "ppl2-k1", "ppl2-ph2-paired-k4-band", "ppl4-k1", "cornell-ph2-k4",
        "cornell-ppl2-ph2-k1-band", "cornell-ppl2-paired-k4"])
def test_two_phase_refill_equals_slot_machine(preset, n_frames, clamp, rows,
                                              ts, ppl, phases, paired):
    """The kernel's two phases (the exact loop, each tile's last finish,
    then each lane's extra samples from its own slot) against the TPU
    kernel's slot machine over the same tiles, bit for bit: image, segment
    map, total and bounce histogram. A 40 x 24 frame, whose right and top
    edges cut tiles; K = 1 and K = 4 from a seeded accumulator; both clamp
    modes; a band of whole tiles; live lanes traced 256 a call. Under the
    lane knobs (pixels a lane ``ppl``, ``phases``, lanes ``paired`` by a
    seeded cost map) the lanes are the TPU kernel's over the config's
    tiles, a lane's border positions past the frame tracing their clamped
    pixels; the slot machine switches a lane's pixel and waits for its
    phase's slots as the TPU kernel does, slot by slot."""
    scene, cam, cfg = _two_phase_case(preset, 40, 24, 2, 3)
    cfg = dataclasses.replace(cfg, clamp_accumulate=clamp)
    y0, y1 = rows or (0, 24)
    acc = costs = None
    if n_frames > 1:
        acc = torch.from_numpy(np.random.RandomState(4).uniform(
            0, 2, (y1 - y0, 40, 3)).astype(np.float32))
    knobs = (ppl, phases) != (1, 1)
    groups = None if knobs else tmk.tile_groups(40, 24, ts)
    if knobs:
        cfg = dataclasses.replace(cfg, mega_tile_size=ts,
                                  mega_pixels_per_lane=ppl, mega_phases=phases)
    if paired:
        costs = torch.from_numpy(
            np.random.RandomState(9).randint(0, 30, (y1 - y0, 40)))
    fn = tmk.plain_intersector(scene, cam, cfg)
    slot = tmk._render_adaptive(scene, cam, cfg, 5, n_frames, acc, True, y0,
                                y1, groups, fn, False, two_phase=False,
                                pair_costs=costs)
    phase_one = {}
    two = tmk._render_adaptive(scene, cam, cfg, 5, n_frames, acc, True, y0,
                               y1, groups, fn, False, phase_one=phase_one,
                               pair_costs=costs)
    assert torch.equal(two[0], slot[0]) and torch.equal(two[2], slot[2])
    assert int(two[1]) == int(slot[1]) and torch.equal(two[3], slot[3])
    # phase 1 is the exact render's segment map; each tile's last finish
    # is its largest lane's sum of its pixels' slots (with one pixel a lane
    # and one phase, its largest entry), and no pixel traced fewer segments
    # than it
    exact = tmk.render_frames_plain(
        scene, cam, dataclasses.replace(cfg, adaptive_spp=False), 5,
        n_frames, accum=acc, rows=rows)
    assert torch.equal(phase_one["segs"], exact[2])
    if knobs:
        perm = None if costs is None else tmk.pair_perm(costs, 40, 24, ts,
                                                        ppl, y0, y1)
        pix, inside = tmk.tile_lanes(40, 24, ts, ppl, y0, y1, perm)
        e = phase_one["slots"].reshape(-1)[pix - y0 * 40].long()
        start = e + (e & 1) if phases == 2 else e
        lanes = start[..., :-1].sum(-1) + e[..., -1]
        assert phase_one["tile_max"].tolist() == lanes.amax(1).tolist()
    else:
        assert torch.equal(phase_one["slots"], phase_one["segs"])
        band = tmk._band_groups(groups, 40, y0, y1)
        seg = phase_one["segs"].reshape(-1)
        for g, t in zip(band, phase_one["tile_max"].tolist()):
            assert t == int(seg[g[g >= 0] - y0 * 40].max())
    assert bool((two[2] >= phase_one["segs"]).all())
    if knobs and not bool(inside[..., -1].any()):
        # every lane's last position lies past the frame (four pixels a
        # lane over tiles of 32 rows on a frame of 24): no pixel takes an
        # extra sample
        assert int(two[1]) == int(exact[2].sum())
    else:
        assert int(two[1]) > int(exact[2].sum())


def test_refill_with_one_pixel_groups_is_exact_spp():
    """A group of one pixel never waits for a neighbour, so the slot
    machine then gives the exact-spp render, bit for bit: the same
    samples, folds and segment counts."""
    scene, cam, cfg = _three_sphere(width=32, height=16, spp=3)
    ad = dataclasses.replace(cfg, adaptive_spp=True)
    one = np.arange(32 * 16).reshape(-1, 1)
    acc0 = torch.from_numpy(
        np.random.RandomState(1).uniform(0, 1.5, (16, 32, 3)).astype(np.float32))
    for frame0, n, acc in ((4, 1, None), (2, 3, acc0)):
        e = tmk.render_frames_plain(scene, cam, cfg, frame0, n, accum=acc,
                                    collect_stats=True)
        r = tmk.render_frames_plain(scene, cam, ad, frame0, n, accum=acc,
                                    collect_stats=True, groups=one)
        assert torch.equal(r[0], e[0]) and torch.equal(r[2], e[2])
        assert int(r[1]) == int(e[1]) and torch.equal(r[3], e[3])


def test_refill_traces_extra_samples():
    """With the default tiles as groups: strictly more segments than exact
    spp, every pixel at least its own, the histogram counting every traced
    segment and every path alive at bounce 0, and the JAX package's own
    refill rule against the exact-spp image."""
    scene, cam, cfg = _three_sphere(width=64, height=32, spp=4)
    exact, e_segs, e_map, _ = tmk.render_frames_plain(scene, cam, cfg, 0)
    ad = dataclasses.replace(cfg, adaptive_spp=True)
    img, segs, seg_map, hist = tmk.render_frames_plain(scene, cam, ad, 0,
                                                       collect_stats=True)
    assert int(segs) > int(e_segs)
    assert bool((seg_map >= e_map).all())
    assert int(hist[0]) >= 64 * 32 * cfg.spp
    assert int(hist.sum()) == int(segs) == int(seg_map.sum())
    assert float((img - exact).abs().mean()) < 0.05
    assert abs(float(img.mean()) - float(exact.mean())) < 0.01
    # the public entry point takes the same path on the CPU
    before = tmk.KERNEL.launches
    assert torch.equal(rtt.render_frame(scene, cam, ad, 0), img)
    assert tmk.KERNEL.launches == before


def test_refill_band_of_whole_groups_equals_full_frame_rows():
    """A band of whole refill tiles (16 rows a tile here) is those rows of
    the whole frame bit for bit; a band that cuts a tile is refused, by
    the plain version and by the entry point's band rule alike."""
    scene, cam, cfg = _three_sphere(width=40, height=40, spp=2, max_bounce=3)
    cfg = dataclasses.replace(cfg, adaptive_spp=True, mega_tile_size=16)
    acc0 = torch.from_numpy(
        np.random.RandomState(2).uniform(0, 2, (40, 40, 3)).astype(np.float32))
    full, _, full_map, _ = tmk.render_frames_plain(scene, cam, cfg, 1, 2,
                                                   accum=acc0)
    for y0, y1 in ((16, 32), (32, 40)):
        band, _, band_map, _ = tmk.render_frames_plain(
            scene, cam, cfg, 1, 2, accum=acc0[y0:y1].contiguous(),
            rows=(y0, y1))
        assert torch.equal(band, full[y0:y1])
        assert torch.equal(band_map, full_map[y0:y1])
    with pytest.raises(ValueError, match="whole groups"):
        tmk.render_frames_plain(scene, cam, cfg, 1, rows=(8, 24))
    with pytest.raises(ValueError, match="whole tiles"):
        tmk.render_frames_mega(scene, cam, cfg, 1, rows=(8, 24))


def test_refill_bands_hold_whole_tiles():
    """The band split's refill bands are multiples of the refill tile's
    side (``refill_band_rows``: 128, a multiple of both default sides, or
    the config's), as the JAX module's are TS-aligned; exact spp keeps
    bands of the kernel's block rows. ``band_rows`` takes a refill band on
    the scene's own tile rows only."""
    from ray_tracing_extended_tpu_torch.parallel import sharding as sh

    scene, cam, cfg = _three_sphere(width=8, height=1080)
    mesh = sh.make_mesh(["cpu"] * 4)
    ad = dataclasses.replace(cfg, adaptive_spp=True)
    assert sh.mega_band_height(None, cfg, mesh) == 272
    assert sh.mega_band_height(None, ad, mesh) == 384
    ad32 = dataclasses.replace(ad, mega_tile_size=32)
    assert sh.mega_band_height(None, ad32, mesh) == 288
    bands = sh.init_accum_mega_bands(None, ad, mesh)
    assert [b.shape[0] for b in bands] == [384, 384, 312, 0]
    assert tmk.refill_tile_size(scene, ad) == 128
    assert tmk.band_rows(scene, ad, (384, 768)) == (384, 768)
    assert tmk.band_rows(scene, ad, (768, 1080)) == (768, 1080)
    assert tmk.band_rows(scene, cfg, (3, 17)) == (3, 17)
    for rows in ((272, 544), (384, 600), (64, 128)):
        with pytest.raises(ValueError, match="whole tiles"):
            tmk.band_rows(scene, ad, rows)
    assert tmk.band_rows(scene, ad32, (64, 128)) == (64, 128)


def test_group_layouts():
    """warp_groups: the CUDA kernel's warps, 16 columns by 2 rows of its
    16x8 block; tile_groups: the TPU kernel's tiles. -1 pads both."""
    g = tmk.warp_groups(40, 5)
    assert g.shape == (3 * 3, 32)
    np.testing.assert_array_equal(g[0], np.r_[np.arange(16), 40 + np.arange(16)])
    np.testing.assert_array_equal(g[2][:8], 32 + np.arange(8))
    assert (g[2][8:16] == -1).all()
    assert (g[6][16:] == -1).all()  # row 5 lies outside
    assert sorted(g[g >= 0].tolist()) == list(range(40 * 5))
    t = tmk.tile_groups(40, 24, 16)
    assert t.shape == (2 * 3, 256)
    assert sorted(t[t >= 0].tolist()) == list(range(40 * 24))
    np.testing.assert_array_equal(t[1][:16], 16 + np.arange(16))
