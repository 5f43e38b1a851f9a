"""Refill's two lane knobs, ``mega_pixels_per_lane`` and ``mega_phases``, and
the cost pairing they enable: the port's plain version on the CPU against
the TPU kernel they come from, run in interpret mode as the JAX package's
own tests run it.

With more than one pixel a lane, a TPU lane traces its pixels of the tile
one after another and only the last takes extra samples; with two phases a
lane starts a camera sample on even slots only and traces a bounce on odd
ones; with a cost map the launcher pairs a lane's pixels heavy with light.
Each changes refill's image, none an exact-spp one. The tile is 32 on both
sides (``tests/conftest.py`` pins the JAX package's ``RTX_MEGA_TS``; the
port takes ``mega_tile_size``). Rule for the comparisons with JAX, as in
``tests/test_torch_adaptive.py``: ``tests/test_megakernel.py``'s
whole-frame rule and segment totals within 1% on the two small presets.
RTIOW's refill, whose pixel means one flipped path can move through its
tile's slowest lane, is compared by its bias in
``tests/test_torch_refill_bias.py``, with the knobs through the
``render_progressive`` and their exact-spp image.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ray_tracing_extended_tpu.kernels import megakernel as jmk
from ray_tracing_extended_tpu.models import presets as jpresets
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.interop import (
    camera_from_arrays,
    scene_from_arrays,
)
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models import presets as tpresets

TS = int(os.environ.get("RTX_MEGA_TS", "32"))
KNOBS = [(2, 1), (4, 1), (1, 2), (2, 2)]
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


def _segs_close(a, b):
    assert abs(int(b) - int(a)) <= 0.01 * int(a), (int(a), int(b))


def _knobbed(preset, ppl, phases, width=64, height=32, spp=4, adaptive=True):
    js, jc, cfg = getattr(jpresets, preset)(width=width, height=height,
                                            spp=spp, max_bounce=4)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive,
                              mega_pixels_per_lane=ppl, mega_phases=phases)
    return js, jc, cfg, dataclasses.replace(cfg, mega_tile_size=TS)


def _acc(seed, height, width):
    return np.random.RandomState(seed).uniform(
        0, 1.5, (height, width, 3)).astype(np.float32)


def _cost_map(seed, height, width):
    return np.random.RandomState(seed).randint(
        0, 60, (height, width)).astype(np.int32)


def test_knob_rules_match_jax(monkeypatch):
    """The port's copies of the JAX package's ``pixels_per_lane`` and
    ``n_phases`` (its ``RTX_MEGA_*`` variables unset) give the same values
    and refuse the same ones; refill resolves both to 1 unless the config
    says otherwise, and a pixel count a lane that does not divide the
    tile's rows of 128 is refused."""
    monkeypatch.delenv("RTX_MEGA_PPL", raising=False)
    monkeypatch.delenv("RTX_MEGA_PHASES", raising=False)
    for adaptive in (False, True):
        for batched in (False, True):
            for paired in (False, True):
                for override in (None, 1, 2, 4, 8):
                    assert tmk.pixels_per_lane(
                        adaptive, batched, paired, override
                    ) == jmk.pixels_per_lane(adaptive, batched, paired,
                                             override)
    for override in (None, 1, 2):
        assert tmk.n_phases(override) == jmk.n_phases(override)
    for mod in (tmk, jmk):
        with pytest.raises(ValueError, match="mega_pixels_per_lane"):
            mod.pixels_per_lane(override=3)
        with pytest.raises(ValueError, match="mega_phases"):
            mod.n_phases(override=3)
    scene, _, cfg = tpresets.three_sphere_scene(width=32, height=16,
                                                device="cpu")
    cfg = dataclasses.replace(cfg, adaptive_spp=True)
    assert tmk.refill_knobs(scene, cfg) == (1, 1)
    assert tmk.refill_knobs(scene, dataclasses.replace(
        cfg, mega_pixels_per_lane=8, mega_phases=2)) == (8, 2)
    assert tmk.launches_per_call(cfg) == 2
    assert tmk.launches_per_call(dataclasses.replace(
        cfg, mega_pixels_per_lane=2)) == 3
    assert tmk.launches_per_call(dataclasses.replace(
        cfg, adaptive_spp=False, mega_pixels_per_lane=2)) == 1
    with pytest.raises(ValueError, match="must divide the tile's 2 rows"):
        tmk.refill_knobs(scene, dataclasses.replace(
            cfg, mega_tile_size=16, mega_pixels_per_lane=4))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("ppl, phases", KNOBS)
def test_refill_knobs_match_tpu_kernel_interpret(preset, ppl, phases):
    """One frame, and two frames in one launch from a seeded accumulator,
    under each knob pair: the port's entry points against the JAX kernel."""
    js, jc, cfg, tcfg = _knobbed(preset, ppl, phases)
    scene, cam = _port(js, jc)
    a, a_segs = jmk.render_frame_mega(js, jc, cfg, jnp.uint32(0),
                                      interpret=True)
    b, b_segs = rtt.render_frame_with_stats(scene, cam, tcfg, 0)
    _tight(np.asarray(a), b.numpy())
    _segs_close(a_segs, b_segs)
    acc0 = _acc(3, 32, 64)
    a, a_segs = jmk.render_frames_mega(js, jc, cfg, jnp.uint32(2),
                                       jnp.asarray(acc0), 2,
                                       interpret=True)[:2]
    b, b_segs = rtt.render_frames_and_accumulate(
        scene, cam, tcfg, torch.from_numpy(acc0), 2, 2)
    _tight(np.asarray(a), b.numpy())
    _segs_close(a_segs, b_segs)


@pytest.mark.parametrize("preset, height", [
    ("three_sphere_scene", 32), ("cornell_box_scene", 32),
    ("three_sphere_scene", 40)], ids=["three_sphere", "cornell", "edge"])
def test_refill_cost_pairing_matches_tpu_kernel_interpret(preset, height):
    """Two pixels a lane paired by a seeded cost map (the launcher's
    ``argsort`` of the negated costs, odd blocks reversed), two frames from
    a seeded accumulator, with the per-pixel segment maps; at 64 x 40 the
    tiles of the bottom row are cut by the frame's edge, whose positions
    take their clamped pixels' costs. The pairing moves the image: without
    the map it differs."""
    js, jc, cfg, tcfg = _knobbed(preset, 2, 1, height=height)
    scene, cam = _port(js, jc)
    acc0 = _acc(3, height, 64)
    costs = _cost_map(7, height, 64)
    a, a_segs, a_map = jmk.render_frames_mega(
        js, jc, cfg, jnp.uint32(2), jnp.asarray(acc0), 2, interpret=True,
        segs_map=True, pair_costs=jnp.asarray(costs))
    b, b_segs, b_map = rtt.render_frames_and_accumulate(
        scene, cam, tcfg, torch.from_numpy(acc0), 2, 2,
        pair_costs=torch.from_numpy(costs), segs_map=True)
    _tight(np.asarray(a), b.numpy())
    _segs_close(a_segs, b_segs)
    assert np.abs(np.asarray(a_map) - b_map.numpy()).mean() < 0.05
    blind, _ = rtt.render_frames_and_accumulate(
        scene, cam, tcfg, torch.from_numpy(acc0), 2, 2)
    assert not torch.equal(blind, b)


def test_lane_pass_wrapper_is_its_plain_version_on_the_cpu():
    """``refill_lanes`` on a CPU tensor: the lane sums of ``tile_lanes``
    counted here one lane at a time, a position past the frame reading its
    clamped pixel, with two phases each pixel but the last taken up to its
    next even slot; resume -1 for a lane's earlier pixels; the tile maxima.
    A band of whole tiles gives those tiles' values."""
    rng = np.random.RandomState(11)
    width, height, ts = 40, 40, 16
    slots = torch.from_numpy(rng.randint(1, 30, (height, width)).astype(
        np.int32))
    costs = torch.from_numpy(rng.randint(0, 9, (height, width)))
    for ppl, phases, paired in ((2, 1, False), (2, 2, True), (1, 2, False)):
        perm = (tmk.pair_perm(costs, width, height, ts, ppl, 0, height)
                if paired else None)
        resume, tile_max = tmk.refill_lanes(slots, width, height, ts, ppl,
                                            phases, (0, height), perm)
        n_tx = -(-width // ts)
        npl = ts * ts // ppl
        want = np.full((height, width), -100)
        maxima = []
        for t in range(n_tx * -(-height // ts)):
            tx, ty = t % n_tx, t // n_tx
            best = 0
            for j in range(npl):
                total = 0
                for p in range(ppl):
                    k = p * npl + j
                    local = int(perm[t, k]) if paired else k
                    ux, uy = tx * ts + local % ts, ty * ts + local // ts
                    e = int(slots[min(uy, height - 1), min(ux, width - 1)])
                    last = p == ppl - 1
                    total += e + (e & 1) if phases == 2 and not last else e
                    if ux < width and uy < height:
                        want[uy, ux] = total if last else -1
                best = max(best, total)
            maxima.append(best)
        np.testing.assert_array_equal(resume.numpy(), want)
        assert tile_max.tolist() == maxima
        band, band_max = tmk.refill_lanes(
            slots[16:32].contiguous(), width, height, ts, ppl, phases,
            (16, 32), None if perm is None else perm[n_tx:2 * n_tx])
        assert torch.equal(band, resume[16:32])
        assert band_max.tolist() == maxima[n_tx:2 * n_tx]
