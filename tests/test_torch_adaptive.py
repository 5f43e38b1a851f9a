"""Adaptive sample refill and the fast scatter sampler: the port's plain
version on the CPU against the TPU kernel they come from, run in interpret
mode as the JAX package's own tests run it, and the refill's invariants.

Refill makes the image depend on how pixels are grouped, so the plain
version takes the grouping: the JAX kernel's TS x TS tiles
(``tile_groups``, TS=32 as ``tests/conftest.py`` pins it) against the JAX
kernel, the CUDA kernel's warps (``warp_groups``) everywhere else. Rule
for the comparisons with JAX: ``tests/test_megakernel.py``'s whole-frame
rule (over 99.5% of pixels within 1e-3, mean abs difference under 1e-3)
holds for refill too, and the segment totals are held within 1%. The rule
could fail where one path flipped by the JAX kernel's 1-ulp u32 -> f32
conversion changes the slowest lane of a tile, and with it every pixel's
extra samples there; at these sizes it does not.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ray_tracing_extended_tpu.kernels.megakernel import (
    render_frame_mega,
    render_frames_mega,
)
from ray_tracing_extended_tpu.models import presets as jpresets
from ray_tracing_extended_tpu.ops import rng as jrng
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.ops import rng as trng

TS = int(os.environ.get("RTX_MEGA_TS", "32"))


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


def _three_sphere(**kw):
    return tpresets.three_sphere_scene(device="cpu", **kw)


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
    """With warps as groups: strictly more segments than exact spp, every
    pixel at least its own, the histogram counting every traced segment
    and every path alive at bounce 0, and the JAX package's own refill
    rule against the exact-spp image."""
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
    scene, cam, cfg = _three_sphere(width=40, height=24, spp=2, max_bounce=3)
    cfg = dataclasses.replace(cfg, adaptive_spp=True)
    acc0 = torch.from_numpy(
        np.random.RandomState(2).uniform(0, 2, (24, 40, 3)).astype(np.float32))
    full, _, full_map, _ = tmk.render_frames_plain(scene, cam, cfg, 1, 2,
                                                   accum=acc0)
    band, _, band_map, _ = tmk.render_frames_plain(
        scene, cam, cfg, 1, 2, accum=acc0[8:14].contiguous(), rows=(8, 14))
    assert torch.equal(band, full[8:14]) and torch.equal(band_map, full_map[8:14])
    with pytest.raises(ValueError, match="whole groups"):
        tmk.render_frames_plain(scene, cam, cfg, 1, rows=(9, 14))


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
