"""The exact kernel's warp schedules, counted on the plain version.

``csrc/megakernel.cu``'s exact kernel runs a slot loop: a lane whose path
ended starts its next camera sample in the next slot, where a loop over
samples and bounces kept it idle until its warp's longest path ended.
``kernels/megakernel.schedule_counts`` counts both schedules from the
segments the lanes trace (slots, live lanes a slot, the sphere and triangle
tests a warp's scan runs: the union of its live lanes' clusters and
chunks; the live lanes of each cluster visit and the steps of the sphere
kernels' warp-cooperative cluster scan); ``warp_schedule_counts`` records
those segments on the plain version over the kernel's warps. On the CPU:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_schedule.py -q
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.kernels import megakernel as mk
from ray_tracing_extended_tpu_torch.models import presets

SCENES = pathlib.Path(rtt.__file__).resolve().parent.parent / "scenes"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests (the suite runs several
    workers on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Two warps, max_bounce 2 (a nested slot is sample * 3 + bounce), two
# clusters of 5 and 7 spheres and one hoisted sphere. Each lane's segments,
# sample by sample, as the clusters each tested.
HAND_LANES = {
    0: [[{0}, {1}, set()], [{0}]],
    1: [[{0, 1}], [set(), {1}]],
    32: [[{1}, set()], [{0}, {0}]],
    33: [[set()], [{1}]],
}


def _hand_records(order, lanes=HAND_LANES, n_bounce=3):
    recs = [(s * n_bounce + b, lane, clusters)
            for lane, samples in lanes.items()
            for s, path in enumerate(samples)
            for b, clusters in enumerate(path)]
    if order == "by_slot":  # as a traced frame appends them
        recs.sort(key=lambda r: (r[0], r[1]))
    slot = np.array([r[0] for r in recs])
    lane = np.array([r[1] for r in recs])
    spheres = np.array([[k in r[2] for k in range(2)] for r in recs])
    return lane, slot, spheres


@pytest.mark.parametrize("order", ["by_lane", "by_slot"])
def test_schedule_counts_of_two_warps_by_hand(order):
    """Nested: warp 0 runs samples of 3 and 2 bounces, warp 1 of 2 and 2: 9
    slots; a slot runs the hoisted sphere and its live lanes' union (warp
    0: 13 + 8 + 1 + 6 + 8, warp 1: 8 + 1 + 13 + 6). The slot loop: a warp
    runs its longest lane's segments, 4 and 4 slots (warp 0: 13 + 8 + 8 +
    6, warp 1: 8 + 8 + 6 + 6)."""
    lane, slot, spheres = _hand_records(order)
    out = mk.schedule_counts(lane, slot, spheres, [5, 7], 1)
    assert out["segments"] == 13
    assert out["lane_sphere_tests"] == 21 + 22 + 21 + 9
    nested, slots = out["nested"], out["slots"]
    assert (nested["slots"], nested["sphere_iterations"]) == (9, 64)
    assert (slots["slots"], slots["sphere_iterations"]) == (8, 63)
    assert nested["lanes_per_slot"] == 13 / 9
    assert slots["lanes_per_slot"] == 13 / 8
    for res in (nested, slots):
        segs = res["lane_segments"]
        assert segs.shape == (34,)
        assert [segs[i] for i in (0, 1, 32, 33)] == [4, 3, 4, 2]
        assert segs.sum() == 13
    assert "triangle_iterations" not in nested


# Two warps, max_bounce 1 (a nested slot is sample * 2 + bounce), clusters
# of 4 and 32 spheres, no hoisted sphere; lanes 0-2 in warp 0, lane 32 in
# warp 1.
VISIT_LANES = {
    0: [[{0}], [{0, 1}, {1}]],
    1: [[{0}, {0}], [{1}]],
    2: [[{1}], [{0}]],
    32: [[{1}, {1}], [set()]],
}


@pytest.mark.parametrize("order", ["by_lane", "by_slot"])
def test_cooperative_scan_counts_of_two_warps_by_hand(order):
    """The (slot, cluster) visits of the kSpheres kernels' warp-cooperative
    scan. Nested: warp 0's slot 0 visits cluster 0 with lanes 0 and 1 and
    cluster 1 with lane 2, slot 1 cluster 0 with lane 1, slot 2 both
    clusters with two lanes each (0, 2; 0, 1), slot 3 cluster 1 with lane
    0; warp 1 cluster 1 with lane 32 at slots 0 and 1: five visits of one
    lane, three of two, 11 ray steps. The slot loop: warp 0's slot 0 as
    the nested one's, slot 1 cluster 0 with lanes 0-2 and cluster 1 with
    lane 0, slot 2 cluster 1 with lanes 0 and 1; warp 1 as before: four
    of one, two of two, one of three, 11 ray steps, the lanes' 11 cluster
    tests either way. The hybrid (``warp_scan_max``) runs a visit of that
    many lanes or more as the cluster's 4 or 32 sphere steps; the per-lane
    loop runs the union's, 172 and 168."""
    lane, slot, spheres = _hand_records(order, VISIT_LANES, n_bounce=2)
    assert int(spheres.sum()) == 11
    for scan_max, steps in ((mk.WARP + 1, (11, 11)), (3, (11, 12)),
                            (2, (45, 44)), (1, (172, 168))):
        out = mk.schedule_counts(lane, slot, spheres, [4, 32], 0,
                                 warp_scan_max=scan_max)
        nested, slots = out["nested"], out["slots"]
        assert (nested["slots"], slots["slots"]) == (7, 6)
        assert nested["visit_lanes"] == [5, 3] + [0] * 30
        assert slots["visit_lanes"] == [4, 2, 1] + [0] * 29
        assert (nested["sphere_ray_steps"], slots["sphere_ray_steps"]) == steps
        assert (nested["cluster_sphere_steps"],
                slots["cluster_sphere_steps"]) == (172, 168)
        assert nested["sphere_iterations"] == 172
    lane, slot, spheres = _hand_records(order)
    out = mk.schedule_counts(lane, slot, spheres, [5, 7], 1)
    for res in (out["nested"], out["slots"]):
        assert res["visit_lanes"] == [8, 1] + [0] * 30
        assert res["sphere_ray_steps"] == 10
        assert res["cluster_sphere_steps"] == 55


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cooperative_scan_steps_are_the_lanes_cluster_tests(seed):
    """Random records over four warps: without the per-lane branch the
    cooperative scan runs one ray step a lane a cluster it tested, in
    either schedule (its visit histogram sums to them); with every visit
    on the per-lane branch it runs the per-lane loop's steps."""
    rng = np.random.default_rng(seed)
    n = 600
    lane = rng.integers(0, 4 * mk.WARP, n)
    slot = rng.integers(0, 12, n)
    # at most one record a lane a nested slot
    _, keep = np.unique(np.stack([lane, slot]), axis=1, return_index=True)
    lane, slot = lane[keep], slot[keep]
    spheres = rng.random((lane.size, 5)) < 0.4
    sizes = rng.integers(1, 33, 5)
    lane_visits = int(spheres.sum())
    for name in mk.SCHEDULES:
        coop = mk.schedule_counts(lane, slot, spheres, sizes, 3,
                                  warp_scan_max=mk.WARP + 1)[name]
        hist = np.array(coop["visit_lanes"])
        assert int(hist @ np.arange(1, mk.WARP + 1)) == lane_visits
        assert coop["sphere_ray_steps"] == lane_visits
        per_lane = mk.schedule_counts(lane, slot, spheres, sizes, 3,
                                      warp_scan_max=1)[name]
        assert per_lane["visit_lanes"] == coop["visit_lanes"]
        assert (per_lane["sphere_ray_steps"]
                == per_lane["cluster_sphere_steps"]
                == coop["sphere_iterations"] - 3 * coop["slots"])


def test_warp_scan_max_is_the_kernels():
    """``WARP_SCAN_MAX`` is the source's kWarpScanMax."""
    src = (pathlib.Path(mk.__file__).resolve().parents[1] / "csrc"
           / "megakernel.cu").read_text()
    m = re.search(r"constexpr int kWarpScanMax = (\d+);", src)
    assert int(m.group(1)) == mk.WARP_SCAN_MAX


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_loop_never_needs_more_slots_than_the_nested_loop(seed):
    """Random path lengths over four warps: the nested loop's slots are the
    sum over a warp's samples of its longest path, the slot loop's a warp's
    longest lane, never more; both hold every segment, and a warp's scan
    runs at least what its busiest lane tests."""
    rng = np.random.default_rng(seed)
    spp, mb, n_lanes = 3, 4, 128
    lengths = rng.integers(1, mb + 2, size=(n_lanes, spp))
    lane, slot = [], []
    for s in range(spp):
        for b in range(mb + 1):
            live = np.flatnonzero(lengths[:, s] > b)
            lane.append(live)
            slot.append(np.full(live.size, s * (mb + 1) + b))
    lane, slot = np.concatenate(lane), np.concatenate(slot)
    spheres = rng.random((lane.size, 6)) < 0.3
    triangles = rng.random((lane.size, 3)) < 0.5
    out = mk.schedule_counts(lane, slot, spheres, rng.integers(1, 9, 6), 2,
                             triangles, [4, 1, 2])
    per_warp = lengths.reshape(-1, mk.WARP, spp)
    nested, slots = out["nested"], out["slots"]
    assert nested["slots"] == int(per_warp.max(axis=1).sum())
    assert slots["slots"] == int(per_warp.sum(axis=2).max(axis=1).sum())
    assert slots["slots"] <= nested["slots"]
    assert out["segments"] == lane.size == int(lengths.sum())
    for res in (nested, slots):
        assert np.array_equal(res["lane_segments"], lengths.sum(axis=1))
        assert res["lanes_per_slot"] * res["slots"] == pytest.approx(lane.size)
        assert 32 * res["sphere_iterations"] >= out["lane_sphere_tests"]
        assert 32 * res["triangle_iterations"] >= out["lane_triangle_tests"]


def _chess(**small):
    return rtt.load_json_scene(SCENES / "chess.json", overrides=small,
                               device="cpu")


@pytest.mark.parametrize("name", ["rtiow", "chess"])
def test_both_schedules_count_the_plain_frames_segments(name):
    """On a band of whole warp rows, the plain version's frame: each
    schedule's per-pixel live slots are the frame's segment map, the lanes'
    own tests are the clustered scan's counts, and the slot loop needs no
    more slots than the nested loop. The band holds a multiple of 256
    pixels, so the plain frame has no padding lane."""
    if name == "rtiow":
        scene, cam, cfg = presets.rtiow_final_scene(
            width=64, height=16, spp=4, max_bounce=4, device="cpu")
        rows = (4, 12)
    else:
        scene, cam, cfg = _chess(width=64, height=36, spp=2, max_bounce=6)
        rows = (16, 20)
    out = mk.warp_schedule_counts(scene, cam, cfg, rows=rows, frame=3)
    counts = {}
    _, total, seg_map, _ = mk.render_frames_plain(
        scene, cam, cfg, 3, rows=rows,
        intersect_fn=mk.plain_intersector(scene, cam, cfg, counts))
    for schedule in mk.SCHEDULES:
        assert np.array_equal(out[schedule]["segment_map"], seg_map.numpy())
    assert out["segments"] == int(total) == counts["segments"]
    assert out["lane_sphere_tests"] == counts["sphere_tests"]
    assert out["warps"] == (rows[1] - rows[0]) // 2 * 64 // 16
    assert out["slots"]["slots"] <= out["nested"]["slots"]
    ratio = out["slots"]["slots"] / out["nested"]["slots"]
    assert out["ratios"]["slots"] == ratio
    if name == "chess":
        assert out["lane_triangle_tests"] == counts["triangle_tests"]
        assert out["nested"]["sphere_iterations"] == 0
        assert out["ratios"]["sphere_iterations"] is None
    else:
        assert "triangle_iterations" not in out["nested"]


def test_warp_schedule_counts_refuses_what_it_cannot_count():
    """A band that cuts a warp's two rows, and a BVH scene, raise."""
    scene, cam, cfg = presets.rtiow_final_scene(width=32, height=8, spp=1,
                                                device="cpu")
    with pytest.raises(ValueError, match="refill group"):
        mk.warp_schedule_counts(scene, cam, cfg, rows=(1, 5))
    scene, cam, cfg = presets.mesh_scene(width=32, height=8, spp=1,
                                         target_tris=500, device="cpu")
    with pytest.raises(ValueError, match="clustered scans"):
        mk.warp_schedule_counts(scene, cam, cfg)
