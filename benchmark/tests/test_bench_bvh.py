"""The BVH cell (``dmc-dog-skin.batch``) on the CPU: the reference against
the port's plain path on the dog's mirror, the yardstick's count
(``bvh_yardstick.py``) against a brute-force recount, the two new readers,
and the check through a whole shrunk run, sound and broken."""

import functools
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bvh_yardstick
import reference
import run
from test_bench_faults import break_step

MIRROR = Path(__file__).parents[1] / "scenes" / "dmc-dog-skin.json"
CELL = "dmc-dog-skin.batch"
# a frame of 256 pixels, the plain path's lane block (a smaller frame's
# segment total counts padding lanes), one sample and one bounce: the
# reference tests every triangle a segment
SHRINK = dict(width=16, height=16, spp=1, max_bounce=1)


def test_reference_matches_port_plain_path_on_the_dog():
    """The port's plain closest hit through its LBVH, in the kernel's
    direct forms, against the reference's brute-force scan: no two
    triangles tie at this size, so the image and every pixel's segments
    are the same bit for bit."""
    from ray_tracing_extended_tpu_torch import load_json_scene
    from ray_tracing_extended_tpu_torch.kernels.megakernel import (
        path_name, plain_intersector, render_frames_plain)

    w, h = 32, 16
    scene, cam, cfg = load_json_scene(
        MIRROR, overrides=dict(width=w, height=h, spp=1, max_bounce=4),
        device="cpu")
    assert path_name(scene, cfg) == "plain closest_hit_clustered<bvh>"
    frame = 4097
    img, segs, seg_map, _ = render_frames_plain(
        scene, cam, cfg, frame,
        intersect_fn=plain_intersector(scene, cam, cfg, direct=True))
    rs, rc, _ = reference.json_scene(MIRROR)
    tr = reference.Tracer(rs, rc, w, h, cfg.max_bounce, cfg.spp, "cpu")
    mean, s = tr.render_lanes(torch.arange(w * h),
                              torch.full((w * h,), frame), 1024)
    assert torch.equal(mean, img.reshape(-1, 3))
    assert torch.equal(s, seg_map.reshape(-1).long())
    assert int(s.sum()) == int(segs)


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    centre = rng.random((n, 1, 3)) * 4.0
    return (centre + rng.normal(size=(n, 3, 3)) * 0.3).astype(np.float32)


def _brute_ops(tree, o, d, t):
    """Every node's box tested against every segment, a node counted when
    it and each node above it are entered."""
    o, d, t = o.numpy(), d.numpy(), t.numpy()
    inv = np.float32(1.0) / d
    t0 = (tree.lo[None] - o[:, None]) * inv[:, None]
    t1 = (tree.hi[None] - o[:, None]) * inv[:, None]
    free = np.isnan(t0) | np.isnan(t1)
    near = np.where(free, -np.inf, np.minimum(t0, t1)).max(-1)
    far = np.where(free, np.inf, np.maximum(t0, t1)).min(-1)
    entered = (near <= far) & (far >= 0) & (near <= t[:, None])
    parent = np.full(len(tree.lo), -1)
    for k in range(len(tree.lo)):
        if tree.left[k] >= 0:
            parent[tree.left[k]] = parent[tree.right[k]] = k
    reached = entered.copy()
    for k in range(1, len(tree.lo)):  # parents come first in build order
        reached[:, k] &= reached[:, parent[k]]
    work = np.where(tree.left >= 0, bvh_yardstick.OPS_NODE,
                    bvh_yardstick.OPS_TRIANGLE * tree.count)
    return bvh_yardstick.OPS_ROOT + (reached * work[None]).sum(1)


@pytest.mark.parametrize("n", [1, 4, 5, 23])
def test_yardstick_count_is_the_brute_force_recount(n):
    tri = _soup(n, n)
    tree = bvh_yardstick.build(tri)
    internal = tree.left >= 0
    assert tree.count.sum() == n and (tree.count[~internal] <= 4).all()
    assert (tree.count[~internal] > 0).all()
    for k in np.nonzero(internal)[0]:
        for c in (tree.left[k], tree.right[k]):
            assert (tree.lo[c] >= tree.lo[k]).all()
            assert (tree.hi[c] <= tree.hi[k]).all()
    rng = np.random.default_rng(7)
    o = torch.tensor(rng.random((64, 3)) * 6 - 1, dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(64, 3)), dtype=torch.float32)
    d[:8, 0] = 0.0  # a zero component: the slab's NaN rule
    d = d / d.norm(dim=1, keepdim=True)
    t = torch.tensor(rng.random(64) * 5, dtype=torch.float32)
    t[::3] = float("inf")
    got = bvh_yardstick.Counter(tree, "cpu").ops(o, d, t)
    np.testing.assert_array_equal(got.numpy(), _brute_ops(tree, o, d, t))
    # a ray that misses the root's box pays for its test alone
    away = bvh_yardstick.Counter(tree, "cpu").ops(
        torch.tensor([[50.0, 50.0, 50.0]]), torch.tensor([[0.0, 1.0, 0.0]]),
        torch.tensor([float("inf")]))
    assert float(away) == bvh_yardstick.OPS_ROOT


def test_yardstick_sah_ops_is_the_area_weighted_sum():
    one = bvh_yardstick.build(_soup(3, 1))
    assert one.sah_ops() == 12 + 34 * 3
    tree = bvh_yardstick.build(_soup(40, 2))
    a = tree.area()
    total = 12.0
    for k in range(len(a)):
        work = 24 if tree.left[k] >= 0 else 34 * tree.count[k]
        total += work * a[k] / a[0]
    assert tree.sah_ops() == pytest.approx(total, rel=1e-12)


def test_the_yardstick_loads_nothing_of_the_program():
    prog = (f"import sys; sys.path[:0] = [{str(run.ROOT)!r}, "
            f"{str(run.HERE)!r}]\nimport bvh_yardstick, json\n"
            "print(json.dumps(sorted({k.split('.')[0]\n"
            "                         for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "ray_tracing_extended_tpu",
                        "ray_tracing_extended_tpu_torch"}


def test_bvh_roofline_mean_ops_reads_the_yardstick(monkeypatch):
    roofline = run.load_reader("bvh_roofline")
    monkeypatch.setattr(roofline, "PAIRS", 32)
    cell = run.load_cell(CELL)
    cfg = SimpleNamespace(width=8, height=8, max_bounce=2, spp=1)
    ops = roofline.mean_ops(dict(cell=cell, cfg=cfg, root=run.HERE), "cpu")
    # at least the root's test and a step into the floor's or skin's tree
    assert ops > bvh_yardstick.OPS_ROOT + bvh_yardstick.OPS_NODE
    assert roofline.read(dict(trace=None, segments=1)) is None


def test_bvh_sah_ops_reads_the_last_build(monkeypatch):
    import sys

    from ray_tracing_extended_tpu_torch.accel import bvh

    reader = run.load_reader("bvh_sah_ops")
    monkeypatch.setattr(bvh.LBVH_BUILDS, "sah_ops", [3.0, 145.5])
    assert reader.read({}) == 145.5
    # a program that records no such number: nothing, and no error
    monkeypatch.setitem(sys.modules, bvh.__name__,
                        SimpleNamespace(LBVH_BUILDS=SimpleNamespace(
                            routes=["native"])))
    assert reader.read({}) is None


@pytest.fixture
def direct_forms(monkeypatch):
    """The port's CPU path in the kernel's test forms, a short warm-up, and
    16 sampled pixels for the image (the segments still from every
    (pixel, frame) pair)."""
    from ray_tracing_extended_tpu_torch.kernels import megakernel

    monkeypatch.setattr(megakernel, "plain_intersector", functools.partial(
        megakernel.plain_intersector, direct=True))
    monkeypatch.setattr(run, "WARM_SECONDS", 0.05)
    monkeypatch.setattr(run, "image_pixels", functools.partial(
        run.image_pixels, strata=(4, 4)))


def go():
    return run.run_cell(CELL, 2 ** 31 + 11, 0.2, False, device="cpu",
                        shrink=SHRINK)


def test_a_sound_dog_run_is_correct(direct_forms):
    result = go()
    assert result["correct"], result["checks"]
    assert result["checks"]["image_gap"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["unchanged", "stream"])
def test_a_broken_dog_step_is_not_correct(direct_forms, fault, monkeypatch):
    """The running average left unchanged, and a frame's random stream
    altered (``test_bench_faults.py``'s half-samples fault needs two
    samples a frame, which the other cells' runs take)."""
    break_step(monkeypatch, fault)
    result = go()
    assert not result["correct"], result["checks"]
