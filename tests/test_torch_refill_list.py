"""Refill's lane list under the lane knobs: with more than one pixel a lane,
the lane pass lists each lane's last pixel of each tile, in the order a
launch over the band gives their threads, and the kernel's phase 2 runs
over that list alone. The plain version's list against a construction here
from the lane definition, and the plain refill's extra samples against the
list: no pixel outside it takes one.

The JAX package's lanes are the reference for ``tile_lanes`` and for the
refill's images (``tests/test_torch_refill_knobs.py``); the list changes no
image, so this file needs no JAX.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models import presets as tpresets


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _thread_rank(ts):
    """Tile-local position (row-major) -> its place among the tile's
    threads of a launch over the band: 16x8 blocks row by row, each block's
    16 x 8 threads row by row."""
    order = [(by * 8 + ty) * ts + bx * 16 + tx
             for by in range(ts // 8) for bx in range(ts // 16)
             for ty in range(8) for tx in range(16)]
    rank = np.empty(ts * ts, np.int64)
    rank[np.asarray(order)] = np.arange(ts * ts)
    return rank


def _expected_list(width, height, ts, ppl, rows, perm):
    """Each tile's lanes' last pixels in the band, by thread order, then -1:
    lane j's last position is ``(ppl - 1) * ts * ts // ppl + j``, or
    ``perm``'s entry there."""
    y0, y1 = rows
    n_tx, n_ty = -(-width // ts), -(-(y1 - y0) // ts)
    npl = ts * ts // ppl
    rank = _thread_rank(ts)
    out = []
    for t in range(n_tx * n_ty):
        x0, top = (t % n_tx) * ts, y0 + (t // n_tx) * ts
        listed = []
        for j in range(npl):
            k = (ppl - 1) * npl + j
            local = int(perm[t, k]) if perm is not None else k
            ux, uy = x0 + local % ts, top + local // ts
            if ux < width and uy < y1:
                listed.append((rank[local], uy * width + ux))
        listed.sort()
        out += [f for _, f in listed] + [-1] * (npl - len(listed))
    return np.asarray(out)


LIST_CASES = [(ppl, phases, paired) for ppl in (2, 4, 8)
              for phases in (1, 2) for paired in (False, True)]


@pytest.mark.parametrize("ppl, phases, paired", LIST_CASES,
                         ids=[f"ppl{p}-ph{h}{'-paired' if c else ''}"
                              for p, h, c in LIST_CASES])
def test_lane_list_is_each_lanes_last_pixel_in_thread_order(ppl, phases,
                                                            paired):
    """``refill_lane_list`` on the CPU, tiles of 32 on an 80 x 72 frame
    whose right and bottom edges cut tiles, the whole frame and a band of
    whole tiles: the list against the construction above; each in-band
    last pixel listed once, exactly the pixels that resume in
    ``refill_lanes``' map, each tile's segment ending in -1 where its
    lanes' last positions leave the frame."""
    rng = np.random.RandomState(5 + ppl + phases)
    width, height, ts = 80, 72, 32
    slots = torch.from_numpy(rng.randint(1, 40, (height, width)).astype(
        np.int32))
    costs = torch.from_numpy(rng.randint(0, 9, (height, width)))
    for rows in ((0, height), (32, 64)):
        band = slice(*rows)
        perm = (tmk.pair_perm(costs[band], width, height, ts, ppl, *rows)
                if paired else None)
        resume = tmk.refill_lanes(slots[band].contiguous(), width, height,
                                  ts, ppl, phases, rows, perm)[0]
        pix, inside = tmk.tile_lanes(width, height, ts, ppl, *rows, perm)
        got = tmk.refill_lane_list(pix, inside, width, ts, rows[0])
        want = _expected_list(width, height, ts, ppl, rows, perm)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        npl = ts * ts // ppl
        for seg in got.reshape(-1, npl).numpy():
            n = int((seg >= 0).sum())
            assert (seg[:n] >= 0).all() and (seg[n:] == -1).all()
        listed = got[got >= 0].long() - rows[0] * width
        assert listed.unique().numel() == listed.numel()
        resumes = torch.nonzero(resume.reshape(-1) >= 0).squeeze(1)
        assert torch.equal(listed.sort().values, resumes)


def test_lane_list_order_is_the_kernels_thread_order():
    """``lane_list_order`` against the blocks and warps enumerated here, at
    every position in the frame of a band's tiles, the band starting below
    row 0: tiles of 16, 32 and 48."""
    width = 100
    for ts in (16, 32, 48):
        y0 = ts
        n_tx = -(-width // ts)
        tiles = torch.arange(2 * n_tx)
        lx, ly = torch.meshgrid(torch.arange(ts), torch.arange(ts),
                                indexing="xy")
        local = (ly * ts + lx).reshape(-1)
        x = (tiles[:, None] % n_tx) * ts + local % ts
        y = y0 + (tiles[:, None] // n_tx) * ts + local // ts
        got = tmk.lane_list_order(y * width + x, width, ts, y0)
        want = torch.from_numpy(_thread_rank(ts))[local].expand_as(got)
        inside = x < width  # a position past the frame is never listed
        assert torch.equal(got[inside], want[inside])


def _scene(preset, width, height, ts):
    scene, cam, cfg = getattr(tpresets, preset)(
        width=width, height=height, spp=2, max_bounce=3, device="cpu")
    return scene, cam, dataclasses.replace(cfg, adaptive_spp=True,
                                           mega_tile_size=ts)


# (preset, pixels a lane, phases, paired, frames, rows, tile side)
LISTED_REFILLS = [
    ("three_sphere_scene", 2, 1, True, 1, None, 16),
    ("three_sphere_scene", 4, 1, True, 2, None, 32),
    ("three_sphere_scene", 2, 2, True, 2, (16, 32), 16),
    ("three_sphere_scene", 2, 1, False, 1, None, 16),
    ("three_sphere_scene", 8, 2, False, 1, None, 32),
    ("cornell_box_scene", 2, 1, True, 2, None, 16),
    ("cornell_box_scene", 4, 1, False, 1, (0, 32), 32),
    ("cornell_box_scene", 2, 2, True, 1, None, 16),
]


@pytest.mark.parametrize(
    "preset, ppl, phases, paired, n_frames, rows, ts", LISTED_REFILLS,
    ids=[f"{p.split('_')[0]}-ppl{q}-ph{h}{'-paired' if c else ''}-k{n}"
         f"{'-band' if r else ''}-ts{t}"
         for p, q, h, c, n, r, t in LISTED_REFILLS])
def test_refill_extra_samples_only_on_listed_pixels(preset, ppl, phases,
                                                    paired, n_frames, rows,
                                                    ts):
    """The plain refill on a 40 x 40 frame whose right and bottom edges cut
    the tiles of 16 or 32, a frame, and two from a seeded accumulator,
    paired by a seeded cost map or not, the whole frame and a band of
    whole tiles: the lane list ``phase_one`` gains is ``refill_lane_list``'s
    of the refill's lanes, it lists exactly the pixels that resume, and a
    pixel outside it traces in phase 2 no segment; so the kernel's phase 2
    over the list alone leaves every other pixel as phase 1 left it."""
    scene, cam, cfg = _scene(preset, 40, 40, ts)
    cfg = dataclasses.replace(cfg, mega_pixels_per_lane=ppl,
                              mega_phases=phases)
    y0, y1 = rows or (0, 40)
    rng = np.random.RandomState(ppl * 10 + phases)
    acc = None
    if n_frames > 1:
        acc = torch.from_numpy(rng.uniform(0, 2, (y1 - y0, 40, 3)).astype(
            np.float32))
    costs = (torch.from_numpy(rng.randint(0, 30, (y1 - y0, 40)))
             if paired else None)
    one = {}
    img, total, segs, hist = tmk.render_frames_plain(
        scene, cam, cfg, 4, n_frames, accum=acc, collect_stats=True,
        rows=rows, phase_one=one, pair_costs=costs)
    perm = (None if costs is None
            else tmk.pair_perm(costs, 40, 40, ts, ppl, y0, y1))
    pix, inside = tmk.tile_lanes(40, 40, ts, ppl, y0, y1, perm)
    lane_list = one["lane_list"]
    assert torch.equal(lane_list,
                       tmk.refill_lane_list(pix, inside, 40, ts, y0))
    listed = torch.zeros((y1 - y0) * 40, dtype=torch.bool)
    listed[lane_list[lane_list >= 0].long() - y0 * 40] = True
    assert torch.equal(listed, one["resume"].reshape(-1) >= 0)
    extra = (segs - one["segs"]).reshape(-1)
    assert bool((extra[~listed] == 0).all()) and bool((extra >= 0).all())
    assert int(extra.sum()) > 0 and int(hist.sum()) == int(total)
    assert bool(torch.isfinite(img).all())


def test_refill_warp_counts_by_hand():
    """``refill_warp_counts`` on a 32 x 4 frame, four warps of 16 x 2: phase
    1's warps over its segment map, phase 2's over the extra segments, over
    the band's grid and over a list of 32 entries a warp, -1 an idle
    lane."""
    one = torch.zeros((4, 32), dtype=torch.int32)
    one[0, 0], one[1, 17], one[3, 31] = 5, 3, 7
    segs = one.clone()
    segs[0, 0] += 4  # warp 0 (rows 0-1, columns 0-15)
    segs[3, 20] += 2  # warp 3 (rows 2-3, columns 16-31)
    segs[2, 1] += 1  # warp 2
    out = tmk.refill_warp_counts(one, segs)
    assert out["phase_1"] == dict(warp_slots=5 + 3 + 7, lane_segments=15,
                                  live_share=15 / (32 * 15))
    assert out["phase_2"] == dict(warp_slots=4 + 2 + 1, lane_segments=7,
                                  live_share=7 / (32 * 7))
    assert "phase_2_list" not in out
    # the three pixels with extra samples in one warp of the list, the
    # other warp idle but for a pixel without any
    lane_list = torch.full((64,), -1, dtype=torch.int32)
    lane_list[:3] = torch.tensor([0, 3 * 32 + 20, 2 * 32 + 1])
    lane_list[40] = 5
    out = tmk.refill_warp_counts(one, segs, lane_list)
    assert out["phase_2_list"] == dict(warp_slots=4, lane_segments=7,
                                       live_share=7 / (32 * 4))
    # a band from row 8: the list holds frame indices
    band = tmk.refill_warp_counts(one, segs, lane_list + (lane_list >= 0) * 256,
                                  y0=8)
    assert band["phase_2_list"] == out["phase_2_list"]


def test_warp_schedule_tool_counts_a_refill_frame(capsys):
    """``tools/warp_schedule.py --refill`` on the CPU: a paired frame under
    two pixels a lane, phase 2's warps over the grid and over the list, the
    same extra segments in both."""
    from ray_tracing_extended_tpu_torch.tools import warp_schedule

    assert warp_schedule.main([
        "--device", "cpu", "--scene", "preset:cornell", "--refill", "2", "1",
        "--paired", "--width", "48", "--height", "32", "--tile-size", "16",
        "--spp", "1", "--frames", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["pixels_per_lane"], out["phases"], out["paired"],
            out["tile"]) == (2, 1, True, 16)
    grid, listed = out["phase_2"], out["phase_2_list"]
    assert grid["lane_segments"] == listed["lane_segments"] > 0
    assert out["list_over_grid"] == listed["warp_slots"] / grid["warp_slots"]
    assert 0 < out["phase_1"]["live_share"] <= 1


def test_scan_ab_summarize_pairs_runs_in_file_order(tmp_path):
    """``tools/scan_ab.py --summarize`` on hand-made lines of three trees
    run in turns: each configuration's medians, ranges, ratio to the base
    and pairs won (the k-th run of each label against the base's k-th), the
    knob lines' launch split and lane pass by their medians; lines of
    other phases ignored."""
    from ray_tracing_extended_tpu_torch.tools import scan_ab

    lines = [dict(label="parent", phase="build")]
    for p, c, g in ((2.0, 1.0, 3.0), (4.0, 5.0, 3.5), (3.0, 2.0, 1.0)):
        for label, ms in (("parent", p), ("change", c), ("grid", g)):
            lines.append(dict(label=label, phase="frames", scene="rtiow",
                              adaptive_spp=True, fast_scatter=False,
                              frame_ms_median=ms))
            lines.append(dict(label=label, phase="knobs",
                              config="rtiow_refill_ppl2_ph1", frame_ms_median=ms,
                              refill_launch_frame_ms=[ms, 0.1, 2 * ms],
                              lane_pass_ms=ms / 100))
    path = tmp_path / "ab.jsonl"
    path.write_text("\n".join(json.dumps(d) for d in lines) + "\n")
    rows = {(r["config"], r["label"]): r
            for r in scan_ab.summarize(path, "parent")}
    assert sorted(rows) == [("rtiow_refill", "change"), ("rtiow_refill", "grid"),
                            ("rtiow_refill_ppl2_ph1", "change"),
                            ("rtiow_refill_ppl2_ph1", "grid")]
    change = rows[("rtiow_refill", "change")]
    assert (change["base_med"], change["label_med"]) == (3.0, 2.0)
    assert change["base_rng"] == [2.0, 4.0] and change["label_rng"] == [1.0, 5.0]
    assert change["ratio"] == 2.0 / 3.0
    assert (change["pairs"], change["pairs_won"]) == (3, 2)
    assert rows[("rtiow_refill", "grid")]["pairs_won"] == 2
    knob = rows[("rtiow_refill_ppl2_ph1", "grid")]
    assert knob["grid_launch_ms"] == [3.0, 0.1, 6.0]
    assert knob["parent_launch_ms"] == [3.0, 0.1, 6.0]
    assert knob["grid_lane_pass_ms"] == 0.03
    assert scan_ab.main(["--summarize", str(path), "--base", "change"]) == 0
