"""Refill under the lane knobs through the port's entry points, against the
JAX package on the CPU (its kernel in interpret mode): RTIOW's refill bias
(ROADMAP Queue C 10), ``render_progressive``'s chained cost pairing, and
the exact-spp image that the knobs leave as it is. The knobs and their
rules are ``tests/test_torch_refill_knobs.py``'s; the tile is 32 on both
sides (``tests/conftest.py`` pins the JAX package's ``RTX_MEGA_TS``).
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ray_tracing_extended_tpu import progressive as jprogressive
from ray_tracing_extended_tpu.kernels import megakernel as jmk
from ray_tracing_extended_tpu.models import presets as jpresets
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch import progressive as tprogressive
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)

TS = int(os.environ.get("RTX_MEGA_TS", "32"))
PRESETS = ["three_sphere_scene", "cornell_box_scene"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over."""
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


def _knobbed(preset, ppl, phases, width=64, height=32, spp=4, adaptive=True):
    js, jc, cfg = getattr(jpresets, preset)(width=width, height=height,
                                            spp=spp, max_bounce=4)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive,
                              mega_pixels_per_lane=ppl, mega_phases=phases)
    return js, jc, cfg, dataclasses.replace(cfg, mega_tile_size=TS)


def test_refill_knobs_through_progressive_match_jax():
    """``render_progressive`` in fused batches of 2 over 5 frames,
    each chunk's per-pixel counts pairing the next one's lanes by cost,
    two pixels a lane and two phases: the port's ``render_progressive``
    against the JAX package's over its kernel (``intersector="mega"``,
    interpret mode on the CPU)."""
    js, jc, cfg, tcfg = _knobbed("three_sphere_scene", 2, 2)
    cfg = dataclasses.replace(cfg, intersector="mega")
    tcfg = dataclasses.replace(tcfg, intersector="mega")
    scene, cam = _port(js, jc)
    a = jprogressive.render_progressive(js, jc, cfg, 5, batch=2)
    b = tprogressive.render_progressive(scene, cam, tcfg, 5, batch=2)
    _tight(np.asarray(a), b.numpy())


@pytest.mark.parametrize("preset", PRESETS)
def test_exact_spp_ignores_the_knobs(preset):
    """Under exact spp the knobs and a cost map change which lane traces a
    pixel, not its samples, two frames from a seeded accumulator: the port's
    image and segment total are its default's bit for bit under each; the
    JAX kernel's segment total is its default's, and its image within two
    ulps of it (its fold at a pixel switch is compiled apart from the
    last one, and XLA on the CPU may contract a multiply-add there:
    ``render_frames_mega``'s note of 1 ulp a fold; 0.7% of Cornell's
    pixels move by one)."""
    acc0 = np.random.RandomState(5).uniform(0, 1.5, (32, 64, 3)).astype(
        np.float32)
    costs = np.random.RandomState(8).randint(0, 60, (32, 64)).astype(
        np.int32)
    outs = {}
    for ppl, phases, paired in ((None, None, False), (2, 2, True),
                                (4, 1, True)):
        js, jc, cfg, tcfg = _knobbed(preset, ppl, phases, adaptive=False)
        scene, cam = _port(js, jc)
        a = jmk.render_frames_mega(
            js, jc, cfg, jnp.uint32(1), jnp.asarray(acc0), 2, interpret=True,
            pair_costs=jnp.asarray(costs) if paired else None)
        b = rtt.render_frames_and_accumulate(
            scene, cam, tcfg, torch.from_numpy(acc0), 1, 2,
            pair_costs=torch.from_numpy(costs) if paired else None)
        outs[ppl] = (np.asarray(a[0]), int(a[1]), b[0].numpy(), int(b[1]))
    base = outs[None]
    _tight(base[0], base[2])
    for ppl in (2, 4):
        np.testing.assert_allclose(outs[ppl][0], base[0], rtol=2.4e-7,
                                   atol=0)
        np.testing.assert_array_equal(outs[ppl][2], base[2])
        assert outs[ppl][1] == base[1] and outs[ppl][3] == base[3]


QC10_FRAMES = (1, 2, 3, 4)


@pytest.fixture(scope="module")
def rtiow_edge():
    """RTIOW at 64 x 40 (tiles of 32: the bottom row of tiles is cut by the
    frame's edge), 16 spp, 4 bounces, with each package's exact-spp image
    mean of frames 1-4."""
    js, jc, cfg = jpresets.rtiow_final_scene(width=64, height=40, spp=16,
                                             max_bounce=4)
    scene, cam = _port(js, jc)
    tcfg = dataclasses.replace(cfg, mega_tile_size=TS)
    exact = {f: (float(np.asarray(jmk.render_frame_mega(
        js, jc, cfg, jnp.uint32(f), interpret=True)[0]).mean()),
        float(rtt.render_frame(scene, cam, tcfg, f).mean()))
        for f in QC10_FRAMES}
    return js, jc, cfg, scene, cam, exact


@pytest.mark.parametrize("ppl", [None, 2], ids=["default", "ppl2"])
def test_refill_bias_agrees_with_the_jax_kernel_on_rtiow(rtiow_edge, ppl):
    """ROADMAP Queue C 10 on the CPU: RTIOW's refill bias in both packages,
    frames 1-4 paired as ``tools/adaptive_bias.py`` pairs them (a frame's
    refill image mean less its exact one), under the defaults and two
    pixels a lane. One flipped path moves a tile's slowest lane and with it
    every pixel's extra samples there, so the two agree in what they
    estimate, not pixel for pixel: the mean delta relative to the exact
    mean within 0.05 points, and the segments over the frames within 0.5%.
    Readings the tolerance was set from (this size, these frames): the
    JAX kernel +0.1412% and the port +0.1398% by default, -0.0496% and
    -0.0638% with two pixels a lane (each frame's delta up to 1.6e-3, the
    two packages' per-frame differences up to 2.0e-4); segments 538,888
    against 538,905 and 415,549 against 415,557."""
    js, jc, cfg, scene, cam, exact = rtiow_edge
    ad = dataclasses.replace(cfg, adaptive_spp=True, mega_pixels_per_lane=ppl)
    tad = dataclasses.replace(ad, mega_tile_size=TS)
    deltas, segs = [], [0, 0]
    for f in QC10_FRAMES:
        a, a_segs = jmk.render_frame_mega(js, jc, ad, jnp.uint32(f),
                                          interpret=True)
        b, b_segs = rtt.render_frame_with_stats(scene, cam, tad, f)
        deltas.append((float(np.asarray(a).mean()) - exact[f][0],
                       float(b.mean()) - exact[f][1]))
        segs[0] += int(a_segs)
        segs[1] += int(b_segs)
    d = np.asarray(deltas)
    mean_exact = np.mean([exact[f][0] for f in QC10_FRAMES])
    rel = d.mean(axis=0) / mean_exact
    assert abs(rel[1] - rel[0]) < 5e-4, rel
    assert abs(segs[1] - segs[0]) <= 0.005 * segs[0], segs
