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

import collections
import ctypes
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


def _records_of(lengths):
    """One record a live slot of each lane: ``lengths`` (T, WARP) the
    lanes' segments, a lane's k-th record in nested slot k."""
    per_lane = np.asarray(lengths).reshape(-1)
    lane = np.repeat(np.arange(per_lane.size), per_lane)
    slot = np.concatenate([np.arange(n) for n in per_lane])
    return lane, slot


def _brute_force_queue(lengths, n_warps):
    """The pixel queue slot by slot: each slot, each warp in turn hands its
    pixel-less lanes the tile's next pixels in lane order (the next tile
    where it runs out), then its lanes with a pixel trace one segment.
    -> (warp-slots with a live lane, the last warp's slots, {(tile, lane):
    (warp, first slot)})."""
    pixels = [list(np.flatnonzero(row)) for row in lengths]
    queue = collections.deque(range(len(pixels)))
    cur = [[] for _ in range(n_warps)]
    left = np.zeros((n_warps, mk.WARP), np.int64)
    idle = np.zeros((n_warps, mk.WARP), bool)
    done = [False] * n_warps
    taken, warp_slots, slot, last = {}, 0, 0, -1
    while not all(done):
        for w in range(n_warps):
            if done[w]:
                continue
            for lane in range(mk.WARP):
                if left[w, lane] or idle[w, lane]:
                    continue
                while not cur[w] and queue:
                    g = queue.popleft()
                    cur[w] = [(g, p) for p in pixels[g]]
                if not cur[w]:
                    idle[w, lane] = True
                    continue
                g, p = cur[w].pop(0)
                taken[(g, p)] = (w, slot)
                left[w, lane] = lengths[g][p]
            if not left[w].any():
                done[w] = True
                continue
            warp_slots += 1
            last = slot
            left[w] -= left[w] > 0
        slot += 1
    return warp_slots, last, taken


QUEUE_CASES = {
    # three full tiles and a partial one on two warps
    "mixed": (2, [[3] * 32, [1, 7] * 16, [5, 0] * 16, [2, 9, 0, 4] + [0] * 28]),
    # tiles with one pixel each (a warp gathers several tiles' pixels)
    "single": (3, [[0] * k + [k + 1] + [0] * (31 - k) for k in range(9)]),
    # more warps than tiles: some take nothing
    "spare": (5, [[4] * 32, [1] * 16 + [6] * 16]),
}


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_queue_schedule_equals_a_brute_force_simulation(case):
    """The queue's list scheduling (``_queue_schedule``, and the slots
    ``schedule_counts`` counts from it) against a slot-by-slot simulation
    of the kernel's rule: the same warp and first slot for every pixel,
    the same warp-slots and the same last slot."""
    n_warps, lengths = QUEUE_CASES[case]
    lengths = np.asarray(lengths)
    warp, first = mk._queue_schedule(lengths, n_warps)
    warp_slots, last, taken = _brute_force_queue(lengths, n_warps)
    assert {(g, p): (int(warp[g, p]), int(first[g, p]))
            for g, p in zip(*np.nonzero(lengths))} == taken
    assert int((warp >= 0).sum()) == len(taken)
    lane, slot = _records_of(lengths)
    out = mk.schedule_counts(lane, slot, np.zeros((lane.size, 1), bool), [1],
                             0, resident_warps=n_warps)["queue"]
    assert out["slots"] == warp_slots
    assert out["makespan"] == last + 1
    assert out["lanes_per_slot"] == lengths.sum() / warp_slots
    assert out["ideal_slots"] == lengths.sum() / (mk.WARP * n_warps)


@pytest.mark.parametrize("seed", [0, 1])
def test_queue_of_one_warp_a_full_tile_is_the_slot_loop(seed):
    """Full tiles on as many warps as tiles (the default): each warp takes
    its own tile at slot 0 and the queue is empty after, so the queue's
    counts are the slot loop's, key for key."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 12, (5, mk.WARP))
    lane, slot = _records_of(lengths)
    spheres = rng.random((lane.size, 4)) < 0.3
    triangles = rng.random((lane.size, 2)) < 0.5
    out = mk.schedule_counts(lane, slot, spheres, [3, 32, 7, 12], 2,
                             triangles, [4, 9])
    queue, slots = out["queue"], out["slots"]
    assert queue["resident_warps"] == 5
    for key in ("slots", "sphere_iterations", "triangle_iterations",
                "visit_lanes", "sphere_ray_steps", "lanes_per_slot"):
        assert queue[key] == slots[key], key
    assert np.array_equal(queue["lane_segments"], slots["lane_segments"])
    assert queue["makespan"] == int(lengths.max())


def test_queue_tiles_and_a_bands_share_of_the_warps():
    """A band's warp tiles are 16x2 pixels, the last row and column of
    tiles partial; its share of a launch's resident warps is its share of
    the tiles, at least one warp."""
    assert mk.queue_tiles(1920, 0, 1080) == 120 * 540
    assert mk.queue_tiles(250, 0, 134) == 16 * 67
    assert mk.queue_tiles(250, 37, 101) == 16 * 32
    cfg = rtt.RenderConfig(width=1920, height=1080)
    assert mk.band_resident_warps(3696, cfg, (528, 544)) == 55
    assert mk.band_resident_warps(4, cfg, (0, 2)) == 1


def test_the_kernels_c_signature_is_the_bindings():
    """``rtx_render``'s parameters in the source, one a ctypes argtype of
    the binding: the outputs, then the stream, last."""
    src = (pathlib.Path(mk.__file__).resolve().parents[1] / "csrc"
           / "megakernel.cu").read_text()
    m = re.search(r"extern \"C\" int rtx_render\((.*?)\) \{", src,
                  re.DOTALL)
    params = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert len(params) == len(mk._RENDER_ARGTYPES)
    assert params[-4:] == ["out", "segs", "hist", "stream"]
    assert mk._RENDER_ARGTYPES[-4:] == [ctypes.c_void_p] * 4
    assert params.index("frame0") == mk._RENDER_ARGTYPES.index(ctypes.c_uint)


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


def test_schedules_of_a_launchs_frames_count_its_segments():
    """Over a K = 2 launch's frames on RTIOW: each schedule's per-pixel
    slots are the K-frame fold's segment map, and on few resident warps the
    queue runs no more warp-slots than the slot loop, with more live lanes
    a slot."""
    scene, cam, cfg = presets.rtiow_final_scene(
        width=64, height=16, spp=2, max_bounce=4, device="cpu")
    rows = (4, 12)
    out = mk.warp_schedule_counts(scene, cam, cfg, rows=rows, frame=1,
                                  n_frames=2, resident_warps=3)
    gen = torch.Generator().manual_seed(0)
    acc = torch.rand((8, 64, 3), generator=gen)
    _, total, seg_map, _ = mk.render_frames_plain(
        scene, cam, cfg, 1, 2, accum=acc, rows=rows)
    for schedule in mk.SCHEDULES:
        assert np.array_equal(out[schedule]["segment_map"], seg_map.numpy())
    assert out["segments"] == int(total)
    queue, slots = out["queue"], out["slots"]
    assert queue["resident_warps"] == 3
    assert queue["slots"] <= slots["slots"]
    assert queue["lanes_per_slot"] >= slots["lanes_per_slot"]
    assert queue["makespan"] >= queue["ideal_slots"]
    assert out["queue_ratios"]["slots"] == queue["slots"] / slots["slots"]


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


# Two blocks (warps 0-3 and 4-7), max_bounce 2, the clusters of 5 and 7
# spheres and the hoisted sphere of HAND_LANES: lanes 0, 33 and 70 in three
# warps of block 0, lane 130 in block 1.
BLOCK_LANES = {
    0: [[{0}, {1}]],
    33: [[{0, 1}], [{1}]],
    70: [[set(), {0}]],
    130: [[{1}]],
}


@pytest.mark.parametrize("order", ["by_lane", "by_slot"])
def test_block_schedule_of_two_blocks_by_hand(order):
    """Block 0's slot 0 visits cluster 0 with lanes 0 and 33 and cluster 1
    with lane 33, its slot 1 cluster 0 with lane 70 and cluster 1 with
    lanes 0 and 33; block 1's slot 0 cluster 1 with lane 130: three slots,
    three visits of one lane and two of two, each one batch of the
    cluster's size (5 + 7, 5 + 7, 7 sphere steps), the busiest warp also
    the hoisted sphere a slot. The warps' slot loop runs 7 warp-slots of
    the hoisted sphere and 43 per-lane cluster steps. Every lane of a block
    is a lane of 100 records on cluster 0 in a third block: four batches,
    one a warp."""
    lane, slot, spheres = _hand_records(order, BLOCK_LANES)
    out = mk.schedule_counts(lane, slot, spheres, [5, 7], 1)
    block, slots = out[mk.BLOCK_SCHEDULE], out["slots"]
    assert block["slots"] == 3 and block["lanes_per_slot"] == 7 / 3
    assert block["block_visit_lanes"] == [3, 2] + [0] * 126
    assert block["block_sphere_steps"] == block["cluster_sphere_steps"] == 31
    assert block["busiest_warp_steps"] == 13 + 13 + 8
    assert block["busiest_warp_steps_per_slot"] == 34 / 3
    assert block["hoisted_sphere_steps"] == slots["slots"] == 7
    assert block["sphere_iterations"] == 7 + 31
    assert slots["cluster_sphere_steps"] == 43
    assert [block["lane_segments"][i] for i in (0, 33, 70, 130)] == [2, 2, 2, 1]
    # lane 70's warp in block 1: that block has two slots, and its slot 0
    # visits cluster 1 with lane 130 alone, its slot 1 cluster 0 with lane 70
    out = mk.schedule_counts(lane, slot, spheres, [5, 7], 1,
                             warp_blocks=[0, 0, 1, 1, 1])
    block = out[mk.BLOCK_SCHEDULE]
    assert block["slots"] == 4
    assert block["block_visit_lanes"] == [3, 2] + [0] * 126
    assert block["busiest_warp_steps"] == 13 + 8 + 8 + 6
    with pytest.raises(ValueError, match="warp_blocks"):
        mk.schedule_counts(lane, slot, spheres, [5, 7], 1, warp_blocks=[0, 0])
    many = np.arange(256, 356)  # lanes 0-99 of block 2
    out = mk.schedule_counts(many, np.zeros(100, np.int64),
                             np.ones((100, 1), bool), [5], 1)
    block = out[mk.BLOCK_SCHEDULE]
    assert block["slots"] == 1 and block["block_visit_lanes"][99] == 1
    assert (block["block_sphere_steps"], block["busiest_warp_steps"]) == (20, 6)
    assert out["slots"]["cluster_sphere_steps"] == 20


def _random_records(rng, n_lanes, n=700, slots=10):
    """Random records on ``n_lanes`` lanes, at most one a lane a nested
    slot, each testing any of five clusters."""
    lane = rng.integers(0, n_lanes, n)
    slot = rng.integers(0, slots, n)
    _, keep = np.unique(np.stack([lane, slot]), axis=1, return_index=True)
    lane, slot = lane[keep], slot[keep]
    return lane, slot, rng.random((lane.size, 5)) < 0.4


@pytest.mark.parametrize("seed", [0, 1])
def test_block_schedule_of_one_warp_a_block_is_the_slot_loop(seed):
    """Records on one warp of each block (warps 0, 4, 8): a block's slot is
    its warp's, a visit one batch of the warp's lanes, so the block
    schedule's counts are the warps' slot loop's with the per-lane cluster
    loop."""
    rng = np.random.default_rng(seed)
    lane, slot, spheres = _random_records(rng, 3 * mk.WARP)
    lane = lane + lane // mk.WARP * (mk.BLOCK_WARPS - 1) * mk.WARP
    sizes = rng.integers(1, 33, 5)
    out = mk.schedule_counts(lane, slot, spheres, sizes, 2)
    block, slots = out[mk.BLOCK_SCHEDULE], out["slots"]
    for key in ("slots", "lanes_per_slot", "cluster_sphere_steps",
                "sphere_iterations"):
        assert block[key] == slots[key], key
    assert block["busiest_warp_steps"] == slots["sphere_iterations"]
    assert block["block_visit_lanes"][:mk.WARP] == slots["visit_lanes"]
    assert not any(block["block_visit_lanes"][mk.WARP:])
    assert np.array_equal(block["lane_segments"], slots["lane_segments"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_schedule_never_runs_more_than_its_warps(seed):
    """Random records over three blocks: the block schedule has no more
    slots than its warps' slot loop, its batches no more sphere steps than
    the warps' per-lane cluster loop, and its slots' busiest warps no more
    than the four warps' slot loop steps (the hoisted spheres with them);
    its visits hold the lanes' cluster tests."""
    rng = np.random.default_rng(seed)
    lane, slot, spheres = _random_records(rng, 3 * mk.BLOCK_WARPS * mk.WARP)
    sizes = rng.integers(1, 33, 5)
    out = mk.schedule_counts(lane, slot, spheres, sizes, 3)
    block, slots = out[mk.BLOCK_SCHEDULE], out["slots"]
    assert block["slots"] <= slots["slots"]
    assert block["block_sphere_steps"] <= slots["cluster_sphere_steps"]
    assert block["busiest_warp_steps"] <= slots["sphere_iterations"]
    hist = np.array(block["block_visit_lanes"])
    assert int(hist @ np.arange(1, hist.size + 1)) == int(spheres.sum())


@pytest.mark.parametrize("name", ["rtiow", "three_sphere"])
def test_block_schedule_counts_the_plain_frames_segments(name):
    """On a band of whole block rows, the plain version's frame: the block
    schedule's per-pixel live slots are the frame's segment map, its
    visits hold the lanes that the warps' visits hold, and on these
    scenes its busiest warps run no more than the four warps'
    slot loop and its batches no more than their per-lane cluster loop."""
    make = (presets.rtiow_final_scene if name == "rtiow"
            else presets.three_sphere_scene)
    scene, cam, cfg = make(width=64, height=16, spp=2, max_bounce=4,
                           device="cpu")
    rows = (8, 16)
    out = mk.warp_schedule_counts(scene, cam, cfg, rows=rows, frame=2)
    _, total, seg_map, _ = mk.render_frames_plain(scene, cam, cfg, 2,
                                                  rows=rows)
    block, slots = out[mk.BLOCK_SCHEDULE], out["slots"]
    assert np.array_equal(block["segment_map"], seg_map.numpy())
    assert np.array_equal(block["segment_map"], slots["segment_map"])
    hist = np.array(block["block_visit_lanes"])
    warp_hist = np.array(slots["visit_lanes"])
    assert int(hist @ np.arange(1, hist.size + 1)) == int(
        warp_hist @ np.arange(1, mk.WARP + 1))
    assert block["slots"] <= slots["slots"]
    assert block["busiest_warp_steps"] <= slots["sphere_iterations"]
    assert block["block_sphere_steps"] <= slots["cluster_sphere_steps"]
    ratios = out["block_ratios"]
    assert ratios["busiest_warp_steps_over_sphere_iterations"] == (
        block["busiest_warp_steps"] / slots["sphere_iterations"])
    assert int(total) == out["segments"]
