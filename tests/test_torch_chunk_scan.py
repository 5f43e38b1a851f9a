"""The chunk geometry's warp-cooperative scan, counted on the plain version
(``kernels/megakernel.schedule_counts``): the lanes of each chunk visit,
the ray steps the cooperative scan runs for them, and the triangle steps of
the per-lane loop it replaces. The kernel itself is held to the per-lane
scan bit for bit on the card (``tests/test_torch_cuda.py``).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.kernels import megakernel as mk
from ray_tracing_extended_tpu_torch.models import presets

SCENES = pathlib.Path(__file__).resolve().parent.parent / "scenes"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chunk_scan_max_is_the_kernels():
    """``CHUNK_SCAN_MAX`` is the source's kChunkScanMax."""
    src = (pathlib.Path(mk.__file__).resolve().parents[1] / "csrc"
           / "megakernel.cu").read_text()
    m = re.search(r"constexpr int kChunkScanMax = (\d+);", src)
    assert int(m.group(1)) == mk.CHUNK_SCAN_MAX


def test_which_scenes_scan_chunks_across_the_warp():
    """A scene goes across the warp only where a chunk is big enough for a
    visit of one lane (32 x runs < CHUNK_SCAN_MAX x size: 3 triangles and
    up at 12); Cornell's six chunks of two stay per lane, Chess's 440 of up
    to 44 do not."""
    assert not mk.chunk_scan_across_warp([2, 2, 1, 2])
    assert mk.chunk_scan_across_warp([2, 3])
    assert mk.chunk_scan_across_warp([33])  # 2 runs: 64 < 12 x 33
    assert not mk.chunk_scan_across_warp([])
    cornell = presets.cornell_box_scene(width=8, height=8, device="cpu")[0]
    chess = rtt.load_json_scene(SCENES / "chess.json", device="cpu")[0]
    assert not mk.geometry_tables(cornell, "chunks").chunk_warp_scan
    assert mk.geometry_tables(chess, "chunks").chunk_warp_scan


def test_a_hand_made_warp():
    """One warp, chunks of 48, 2, 32 and 70 triangles (2, 1, 1 and 3 runs
    of 32). Slot 0: lanes 0-4 enter chunk 0 (5 x 32 x 2 < 12 x 48: across
    the warp, 10 ray steps), lanes 0-19 chunk 1 (20 x 32 >= 12 x 2: per
    lane, 2 triangle steps), lane 7 chunk 2 (1 ray step), every lane chunk
    3 (per lane, 70). Slot 1: lane 3 alone enters chunk 3 (3 ray steps)."""
    lanes = np.arange(32)
    lane = np.r_[lanes, 3]
    nested = np.r_[np.zeros(32, np.int64), 1]
    tri = np.zeros((33, 4), bool)
    tri[:5, 0] = True
    tri[:20, 1] = True
    tri[7, 2] = True
    tri[:32, 3] = True
    tri[32, 3] = True
    sizes = [48, 2, 32, 70]
    spheres = np.zeros((33, 1), bool)
    out = mk.schedule_counts(lane, nested, spheres, [4], 0, tri, sizes)
    slots = out["slots"]
    assert slots["slots"] == 2
    assert slots["chunk_triangle_steps"] == 48 + 2 + 32 + 70 + 70
    assert slots["triangle_iterations"] == slots["chunk_triangle_steps"]
    assert slots["triangle_ray_steps"] == 10 + 2 + 1 + 70 + 3
    hist = np.zeros(32, np.int64)
    for k in (5, 20, 1, 32, 1):
        hist[k - 1] += 1
    assert slots["chunk_visit_lanes"] == hist.tolist()
    # every visit across the warp with a bound above 32 lanes a run, none
    # with a bound of 1
    every = mk.schedule_counts(lane, nested, spheres, [4], 0, tri, sizes,
                               chunk_scan_max=10**6)["slots"]
    assert every["triangle_ray_steps"] == 5 * 2 + 20 + 1 + 32 * 3 + 3
    none = mk.schedule_counts(lane, nested, spheres, [4], 0, tri, sizes,
                              chunk_scan_max=1)["slots"]
    assert none["triangle_ray_steps"] == none["chunk_triangle_steps"]


def _union_steps(lane, triangles, sizes):
    """The per-lane loop's triangle steps recounted slot by slot: each
    warp's slot k (its lanes' k-th segments) runs the union of its lanes'
    chunks, each chunk's size once."""
    per = {}
    seen = {}
    for r, ln in enumerate(lane.tolist()):
        k = seen.get(ln, 0)
        seen[ln] = k + 1
        key = (ln // 32, k)
        per[key] = per.get(key, np.zeros(len(sizes), bool)) | triangles[r]
    return int(sum(int(m @ sizes) for m in per.values()))


@pytest.mark.parametrize("name", ["chess", "cornell"])
def test_chunk_counts_on_a_band(name):
    """On a band of whole warp rows of Chess (its shipped camera, 128 x 36,
    2 bounces) and of Cornell: the per-lane loop's triangle steps are the
    slot loop's union of chunks, as counted before the cooperative scan
    (recounted here slot by slot); the cooperative scan's ray steps are at
    most those, and Cornell's chunks (two triangles each) all stay per
    lane."""
    if name == "chess":
        scene, cam, cfg = rtt.load_json_scene(
            SCENES / "chess.json", device="cpu",
            overrides=dict(width=128, height=36, spp=1, max_bounce=2))
        rows = (16, 20)
    else:
        scene, cam, cfg = presets.cornell_box_scene(
            width=64, height=32, spp=2, max_bounce=3, device="cpu")
        rows = (14, 18)
    captured = {}
    count = mk.schedule_counts

    def keep(*args, **kwargs):
        captured["args"] = args
        return count(*args, **kwargs)

    try:
        mk.schedule_counts = keep
        out = mk.warp_schedule_counts(scene, cam, cfg, rows=rows)
    finally:
        mk.schedule_counts = count
    lane, _, _, _, _, triangles, sizes = captured["args"][:7]
    slots = out["slots"]
    assert slots["chunk_triangle_steps"] == _union_steps(lane, triangles,
                                                         sizes)
    assert 0 < slots["triangle_ray_steps"] <= slots["chunk_triangle_steps"]
    assert sum(slots["chunk_visit_lanes"]) > 0
    assert out["ratios"]["triangle_ray_steps"] is not None
    if name == "cornell":
        assert (sizes <= 2).all()
        assert slots["triangle_ray_steps"] == slots["chunk_triangle_steps"]
