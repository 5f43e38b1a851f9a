"""The CUDA kernels on the card: the path-trace kernel against its plain
PyTorch version, its launch count and outputs, its band launches against
its whole-frame launch, and what it refuses; its profiling instantiations
against their production twins; the two roofline probes against theirs.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.kernels import megakernel as mk
from ray_tracing_extended_tpu_torch.models import presets
from ray_tracing_extended_tpu_torch.tools import pairblock_roofline as pairblock
from ray_tracing_extended_tpu_torch.tools import profile_mega
from ray_tracing_extended_tpu_torch.tools import vpu_roofline as vpu

pytestmark = pytest.mark.cuda

SCENES = pathlib.Path(rtt.__file__).resolve().parent.parent / "scenes"


def _triangle_scene(name, device="cuda", **small):
    """Cornell (the preset), the 70k-triangle mesh (the preset, with its
    BVH) or Chess (the shipped mirror) at a small size."""
    if name == "cornell":
        return presets.cornell_box_scene(device=device, **small)
    if name == "mesh":
        return presets.mesh_scene(device=device, **small)
    return rtt.load_json_scene(SCENES / f"{name}.json", overrides=small,
                               device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _on(dev, scene, cam, cfg):
    return scene.to(dev), cam.to(dev), cfg


def test_kernel_matches_plain_gates(cuda):
    """bench.py's tight gates at a small size: bit-exact pixels at mb0
    without defocus; median relative difference and channel means at mb1."""
    scene, cam, cfg = _on(cuda, *presets.rtiow_final_scene(
        width=96, height=54, max_bounce=0, spp=8))
    cam = cam.replace(defocus_strength=0.0)
    k = mk.render_frames_mega(scene, cam, cfg, 5)[0]
    p = mk.render_frames_plain(scene, cam, cfg, 5)[0]
    rel = ((k - p).abs() / (1.0 + p.abs())).amax(-1)
    assert float((rel == 0).float().mean()) > 0.85

    cfg = dataclasses.replace(cfg, max_bounce=1)
    k = mk.render_frames_mega(scene, cam, cfg, 5)[0].double()
    p = mk.render_frames_plain(scene, cam, cfg, 5)[0].double()
    rel = ((k - p).abs() / (1.0 + p.abs())).amax(-1)
    assert float(rel.median()) < 2e-3
    km, pm = k.mean((0, 1)), p.mean((0, 1))
    assert float(((km - pm).abs() / pm).max()) < 5e-3


def _gates(k, p):
    """(bit-exact share, median per-pixel relative difference, largest
    channel-mean relative difference)."""
    k, p = k.double(), p.double()
    rel = ((k - p).abs() / (1.0 + p.abs())).amax(-1)
    km, pm = k.mean((0, 1)), p.mean((0, 1))
    return (float((rel == 0).double().mean()), float(rel.median()),
            float(((km - pm).abs() / pm).max()))


@pytest.mark.parametrize("clamp", [False, True])
def test_kernel_fold_matches_plain(cuda, clamp):
    """The kernel's K-frame fold from a seeded accumulator against the plain
    version's ops/accumulate.py fold: bit-exact pixels at mb0 without
    defocus, and bench.py's mb1 gates at mb1."""
    scene, cam, cfg = _on(cuda, *presets.rtiow_final_scene(
        width=96, height=54, max_bounce=0, spp=4))
    cam = cam.replace(defocus_strength=0.0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    acc0 = 2.0 * torch.rand((54, 96, 3), generator=gen, device=cuda)
    for mb in (0, 1):
        cfg = dataclasses.replace(cfg, max_bounce=mb, clamp_accumulate=clamp)
        k = mk.render_frames_mega(scene, cam, cfg, 2, 3, accum=acc0)[0]
        p = mk.render_frames_plain(scene, cam, cfg, 2, 3, accum=acc0)[0]
        exact, median, channel = _gates(k, p)
        if mb == 0:
            assert exact > 0.85
        assert median < 2e-3 and channel < 5e-3, (mb, median, channel)
        if clamp:
            assert float(k.min()) >= 0.0 and float(k.max()) <= 1.0


@pytest.mark.parametrize("name", ["cornell", "chess"])
def test_triangle_kernel_matches_plain_gates(cuda, name):
    """The triangle variant against the plain version: bench.py's gates at
    mb0 without defocus, mb1 without defocus, and mb4 with the scene's
    own camera."""
    scene, cam, cfg = _on(cuda, *_triangle_scene(
        name, width=96, height=54, max_bounce=0, spp=4))
    still = cam.replace(defocus_strength=0.0)
    before = mk.KERNEL.variant_launches[mk.VARIANT_TRIANGLES]
    for mb, spp, c in ((0, 4, still), (1, 4, still), (4, 2, cam)):
        cfg = dataclasses.replace(cfg, max_bounce=mb, spp=spp)
        k = mk.render_frames_mega(scene, c, cfg, 5)[0]
        p = mk.render_frames_plain(scene, c, cfg, 5)[0]
        assert bool(torch.isfinite(k).all())
        exact, median, channel = _gates(k, p)
        if mb == 0:
            assert exact > 0.85, exact
        elif mb == 1:
            assert median < 2e-3 and channel < 5e-3, (median, channel)
        else:
            assert channel < 1e-2, channel
    assert mk.KERNEL.variant_launches[mk.VARIANT_TRIANGLES] == before + 3


@pytest.mark.parametrize("clamp", [False, True])
def test_triangle_kernel_fold_matches_plain(cuda, clamp):
    """The triangle variant's K-frame fold from a seeded accumulator, in
    both clamp modes: bit-exact pixels at mb0, the mb1 gates at mb1."""
    scene, cam, cfg = _on(cuda, *_triangle_scene(
        "chess", width=96, height=54, max_bounce=0, spp=2))
    cam = cam.replace(defocus_strength=0.0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    acc0 = 2.0 * torch.rand((54, 96, 3), generator=gen, device=cuda)
    for mb in (0, 1):
        cfg = dataclasses.replace(cfg, max_bounce=mb, clamp_accumulate=clamp)
        k = mk.render_frames_mega(scene, cam, cfg, 2, 3, accum=acc0)[0]
        p = mk.render_frames_plain(scene, cam, cfg, 2, 3, accum=acc0)[0]
        exact, median, channel = _gates(k, p)
        if mb == 0:
            assert exact > 0.85
        assert median < 2e-3 and channel < 5e-3, (mb, median, channel)
        if clamp:
            assert float(k.min()) >= 0.0 and float(k.max()) <= 1.0


@pytest.mark.parametrize("name", ["chess", "mesh"])
def test_triangle_scene_never_takes_the_plain_path(cuda, monkeypatch, name):
    """Through the public entry points a triangle scene on the card runs its
    instantiation (chunk scan for Chess, the BVH for the mesh), one launch
    a call, and nothing of the plain path."""

    def refuse(*args, **kwargs):
        raise AssertionError("the plain path ran on a CUDA scene")

    for fn in ("render_frames_plain", "_render_frame_plain", "render_block"):
        monkeypatch.setattr(mk, fn, refuse)
    monkeypatch.setattr(mk, "closest_hit_bvh", refuse)
    scene, cam, cfg = _on(cuda, *_triangle_scene(
        name, width=64, height=36, max_bounce=3, spp=1))
    launched = mk.variant(mk.geometry(scene, cfg))
    assert launched == (mk.VARIANT_BVH if name == "mesh"
                        else mk.VARIANT_TRIANGLES)
    before = dict(mk.KERNEL.variant_launches)
    img, segs, hist = rtt.render_frame_with_stats(scene, cam, cfg, 0,
                                                  bounce_stats=True)
    acc = torch.zeros((36, 64, 3), device=cuda)
    acc, segs3 = rtt.render_frames_and_accumulate(scene, cam, cfg, acc, 0, 3)
    acc = rtt.render_and_accumulate(scene, cam, cfg, acc, 3)
    torch.cuda.synchronize()
    after = mk.KERNEL.variant_launches
    grew = {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}
    assert grew == {launched: 3}
    assert bool(torch.isfinite(img).all() and torch.isfinite(acc).all())
    hist = hist.cpu()
    assert int(hist[0]) == 64 * 36 and int(hist.sum()) == int(segs)
    assert int(segs3) >= 3 * 64 * 36


def test_plain_on_card_matches_plain_on_cpu(cuda):
    """The plain version computes its transcendentals in float64 on the CPU
    and with the card's f32 library on CUDA; the two are held to the
    tolerance the CPU tests hold the port to against the JAX package."""
    scene, cam, cfg0 = presets.rtiow_final_scene(width=48, height=27, spp=2,
                                                 device="cpu")
    for mb, limit in ((1, 5e-3), (4, 2e-2)):
        cfg = dataclasses.replace(cfg0, max_bounce=mb, clamp_accumulate=False)
        c = mk.render_frames_plain(scene, cam, cfg, 5)[0]
        g = mk.render_frames_plain(scene.to(cuda), cam.to(cuda), cfg, 5)[0]
        _, median, channel = _gates(g.cpu(), c)
        assert channel < limit, (mb, channel)
        if mb == 1:
            assert median < 2e-3


def test_kernel_counts_and_outputs(cuda):
    scene, cam, cfg = _on(cuda, *presets.three_sphere_scene(
        width=40, height=24, spp=2))
    before = mk.KERNEL.launches
    img, segs, hist = rtt.render_frame_with_stats(scene, cam, cfg, 0,
                                                  bounce_stats=True)
    torch.cuda.synchronize()
    assert mk.KERNEL.launches == before + 1
    assert img.shape == (24, 40, 3) and img.device == cuda
    assert bool(torch.isfinite(img).all())
    hist = hist.cpu()
    assert int(hist[0]) == 40 * 24 * 2
    assert int(hist.sum()) == int(segs)
    assert all(hist[i] >= hist[i + 1] for i in range(cfg.max_bounce))

    acc = torch.zeros((24, 40, 3), device=cuda)
    acc, segs3, seg_map = rtt.render_frames_and_accumulate(
        scene, cam, cfg, acc, 0, n_frames=3, segs_map=True)
    assert mk.KERNEL.launches == before + 2  # all three frames in one launch
    assert seg_map.shape == (24, 40) and int(seg_map.sum()) == int(segs3)
    assert int(seg_map.min()) >= 3 * cfg.spp


def test_batched_launch_equals_sequential_steps(cuda):
    scene, cam, cfg = _on(cuda, *presets.three_sphere_scene(
        width=40, height=24, spp=2))
    for clamp in (True, False):
        cfg = dataclasses.replace(cfg, clamp_accumulate=clamp)
        acc0 = torch.rand((24, 40, 3), device=cuda)
        batched, _ = rtt.render_frames_and_accumulate(scene, cam, cfg, acc0, 2, 3)
        seq = acc0
        for f in range(2, 5):
            seq = rtt.render_and_accumulate(scene, cam, cfg, seq, f)
        assert torch.equal(batched, seq)


def test_cuda_refuses_what_the_kernel_does_not_do(cuda):
    """The BVH intersector on scenes without a BVH renders through the
    scan instantiations, bit for bit the default's image; adaptive refill
    and fast scatter render through their instantiations. Bad accumulators
    and a camera on another device are refused."""
    scene, cam, cfg = _on(cuda, *presets.three_sphere_scene(
        width=16, height=8, spp=1))
    tri_scene, tri_cam, tri_cfg = _on(cuda, *presets.cornell_box_scene(
        width=16, height=16, spp=1))
    for s, c, base in ((scene, cam, cfg), (tri_scene, tri_cam, tri_cfg)):
        by_bvh = rtt.render_frame(s, c, dataclasses.replace(base, intersector="bvh"), 0)
        assert torch.equal(by_bvh, rtt.render_frame(s, c, base, 0))
        for change in (dict(adaptive_spp=True), dict(fast_scatter=True),
                       dict(adaptive_spp=True, fast_scatter=True)):
            img = rtt.render_frame(s, c, dataclasses.replace(base, **change), 0)
            assert bool(torch.isfinite(img).all())
    with pytest.raises(ValueError):
        rtt.render_frames_and_accumulate(
            scene, cam, cfg, torch.zeros((8, 16, 3), device=cuda)[:, ::1, :2], 0)
    with pytest.raises(ValueError):
        rtt.render_frame(scene, cam.to("cpu"), cfg, 0)


def test_kernel_refuses_box_levels_off_the_rule(cuda):
    """The chunk scan's box levels follow from the chunk count
    (``mk.super_levels``): a launch whose box rows hold the first level
    alone, where the rule asks for two, is refused, and the scene renders
    again once its rows are whole."""
    from chunk_scenes import tile_scene

    scene, cam, cfg = tile_scene(mk.SUPER_CHUNKS ** 2 + 1, device=cuda,
                                 width=32, height=16)
    tab = mk.geometry_tables(scene, "chunks")
    whole = tab.supers
    ref = mk.render_frames_mega(scene, cam, cfg, 3)[0]
    tab.supers = whole[:mk.super_levels(scene.chunks.num_tris.shape[0])[0]]
    try:
        with pytest.raises(RuntimeError, match="invalid argument"):
            mk.render_frames_mega(scene, cam, cfg, 3)
    finally:
        tab.supers = whole
    assert torch.equal(mk.render_frames_mega(scene, cam, cfg, 3)[0], ref)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("name", ["rtiow", "cornell", "chess", "mesh"])
def test_refill_and_fast_scatter_match_plain_gates(cuda, name, adaptive, fast):
    """Each instantiation against the plain version with the kernel's warp
    grouping: bench.py's gates at mb0 and mb1 without defocus, mb4 with
    the scene's camera; launches counted under the instantiation's name
    (the mesh, 70k triangles, through the BVH instantiations)."""
    if name == "rtiow":
        scene, cam, cfg = presets.rtiow_final_scene(width=96, height=54, spp=4)
    else:
        scene, cam, cfg = _triangle_scene(name, width=96, height=54, spp=4)
    still = cam.replace(defocus_strength=0.0)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive, fast_scatter=fast)
    name_k = mk.variant(mk.geometry(scene, cfg), adaptive, fast)
    assert (name == "mesh") == name_k.startswith(("render_kernel<kBvh",
                                                  "render_adaptive<kBvh"))
    before = mk.KERNEL.variant_launches[name_k]
    for mb, c in ((0, still), (1, still), (4, cam)):
        cfg = dataclasses.replace(cfg, max_bounce=mb)
        k, k_segs, k_map, k_hist = mk.render_frames_mega(scene, c, cfg, 5,
                                                         collect_stats=True)
        p = mk.render_frames_plain(scene, c, cfg, 5)[0]
        assert bool(torch.isfinite(k).all())
        exact, median, channel = _gates(k, p)
        if mb == 0:
            assert exact > 0.85, exact
        elif mb == 1:
            assert median < 2e-3 and channel < 5e-3, (median, channel)
        else:
            assert channel < 1e-2, channel
        k_hist = k_hist.cpu()
        assert int(k_hist.sum()) == int(k_segs) == int(k_map.sum())
        assert int(k_hist[0]) >= 96 * 54 * cfg.spp
    assert mk.KERNEL.variant_launches[name_k] == (
        before + 3 * mk.launches_per_call(cfg))


def _exact_case(name, cuda):
    """A scene for the exact kernel's bit-for-bit tests -> ``(scene, camera,
    config, rows)``: rows of the frame the checks compare (None: the
    whole frame). Chess is a crop, a band of its shipped 1280x720 frame
    (3 spp, 15 bounces, defocus 180); the 14,401-sphere scene takes the
    global route."""
    from ray_tracing_extended_tpu_torch.models.wide_scenes import (
        HALF_PAST_LIMIT,
        wide_sphere_scene,
    )

    small = dict(spp=2, max_bounce=4, device=cuda)
    if name.startswith("rtiow"):
        w, h = (96, 54) if name == "rtiow_96" else (192, 108)
        return (*presets.rtiow_final_scene(width=w, height=h, **small), None)
    if name == "chess":
        return (*rtt.load_json_scene(SCENES / "chess.json", device=cuda),
                (352, 368))
    if name == "wide":
        return (*wide_sphere_scene(presets, HALF_PAST_LIMIT, width=96,
                                   height=54, **small), None)
    return (*_triangle_scene(name, width=96, height=54, **small), None)


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("name", ["rtiow_96", "rtiow_192", "cornell", "chess",
                                  "mesh", "wide"])
def test_exact_kernel_equals_plain_bit_for_bit(cuda, name):
    """The exact kernel's slot loop draws, sums and folds each lane as a
    loop over frames, samples and bounces does: against
    ``render_frames_plain`` in the kernel's test forms
    (``plain_intersector(..., direct=True)``) a frame's image, segment map
    and histogram, and a K = 4 fold from a seeded accumulator in both clamp
    modes, are equal bit for bit; so is the fold of a band launch to the
    whole-frame launch's rows. One launch of the instantiation a call."""
    scene, cam, cfg, rows = _exact_case(name, cuda)
    fn = mk.plain_intersector(scene, cam, cfg, direct=True)
    v = mk.path_name(scene, cfg)
    geom = mk.geometry(scene, cfg)
    route = "global" if name == "wide" else "staged"
    assert v == mk.variant(geom, tables=route)
    sl = slice(None) if rows is None else slice(*rows)
    before = mk.KERNEL.variant_launches[v]
    k_img, k_segs, k_map, k_hist = mk.render_frames_mega(
        scene, cam, cfg, 5, collect_stats=True, rows=rows)
    p_img, _, p_map, p_hist = mk.render_frames_plain(
        scene, cam, cfg, 5, collect_stats=True, rows=rows, intersect_fn=fn)
    assert _bits_equal(k_img, p_img)
    assert torch.equal(k_map, p_map) and torch.equal(k_hist, p_hist)
    assert int(k_segs) == int(k_map.sum()) == int(k_hist.sum())
    gen = torch.Generator(device=cuda).manual_seed(7)
    acc0 = 2.0 * torch.rand((cfg.height, cfg.width, 3), generator=gen,
                            device=cuda)
    band = (10, 27) if rows is None else (rows[0] + 3, rows[1] - 5)
    for clamp in (False, True):
        ccfg = dataclasses.replace(cfg, clamp_accumulate=clamp)
        k, _, k_map, _ = mk.render_frames_mega(scene, cam, ccfg, 2, 4,
                                               accum=acc0)
        p, _, p_map, _ = mk.render_frames_plain(
            scene, cam, ccfg, 2, 4, accum=acc0[sl].contiguous(), rows=rows,
            intersect_fn=fn)
        assert _bits_equal(k[sl], p) and torch.equal(k_map[sl], p_map)
        b, b_segs, b_map, _ = mk.render_frames_mega(
            scene, cam, ccfg, 2, 4, accum=acc0[slice(*band)].contiguous(),
            rows=band)
        assert _bits_equal(b, k[slice(*band)])
        assert torch.equal(b_map, k_map[slice(*band)])
        assert int(b_segs) == int(b_map.sum())
        if clamp:
            assert float(k.min()) >= 0.0 and float(k.max()) <= 1.0
    torch.cuda.synchronize()
    assert mk.KERNEL.variant_launches[v] == before + 5


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["rtiow", "cornell", "chess", "mesh"])
def test_refill_at_depth_zero_equals_exact_kernel(cuda, name, fast):
    """At max_bounce 0 every sample is one segment, so all lanes of a warp
    finish their quota in the same slot and refill adds no sample. The
    refill kernel then gives the exact kernel's image, segment map and
    histogram bit for bit: the two schedules of one slot loop differ only
    in which dead lanes start a sample."""
    if name == "rtiow":
        scene, cam, cfg = presets.rtiow_final_scene(width=100, height=54, spp=3)
    else:
        scene, cam, cfg = _triangle_scene(name, width=100, height=54, spp=3)
    cfg = dataclasses.replace(cfg, max_bounce=0, fast_scatter=fast)
    gen = torch.Generator(device=cuda).manual_seed(4)
    acc0 = 2.0 * torch.rand((54, 100, 3), generator=gen, device=cuda)
    exact = mk.render_frames_mega(scene, cam, cfg, 3, 2, accum=acc0,
                                  collect_stats=True)
    refill = mk.render_frames_mega(
        scene, cam, dataclasses.replace(cfg, adaptive_spp=True), 3, 2,
        accum=acc0, collect_stats=True)
    assert torch.equal(refill[0], exact[0])
    assert int(refill[1]) == int(exact[1]) == 100 * 54 * 2 * cfg.spp
    assert torch.equal(refill[2], exact[2])
    assert torch.equal(refill[3], exact[3])


@pytest.mark.parametrize("clamp", [False, True])
def test_refill_fold_matches_plain(cuda, clamp):
    """The refill kernel's K-frame fold from a seeded accumulator, spheres
    and triangles, on a band of whole refill tiles (16 rows, the config's)
    of the plain version."""
    for make in (presets.rtiow_final_scene, presets.cornell_box_scene):
        scene, cam, cfg = make(width=96, height=54, max_bounce=1, spp=4)
        cam = cam.replace(defocus_strength=0.0)
        cfg = dataclasses.replace(cfg, adaptive_spp=True,
                                  clamp_accumulate=clamp, mega_tile_size=16)
        gen = torch.Generator(device=cuda).manual_seed(2)
        acc0 = 2.0 * torch.rand((54, 96, 3), generator=gen, device=cuda)
        k, _, k_map, _ = mk.render_frames_mega(scene, cam, cfg, 2, 3, accum=acc0)
        p, _, p_map, _ = mk.render_frames_plain(
            scene, cam, cfg, 2, 3, accum=acc0[16:32].contiguous(),
            rows=(16, 32))
        _, median, channel = _gates(k[16:32], p)
        assert median < 2e-3 and channel < 5e-3, (median, channel)
        assert int(k_map.min()) >= 3 * cfg.spp
        if clamp:
            assert float(k.min()) >= 0.0 and float(k.max()) <= 1.0


def test_render_command_on_the_card(cuda, tmp_path):
    """The CLI on the card with refill, fused batches, a checkpoint and a
    resume: only the refill instantiation launches."""
    from ray_tracing_extended_tpu_torch.cli import main

    ck, out = tmp_path / "ck.npz", tmp_path / "out.npy"
    args = ["render", "--scene", "preset:rtiow", "--width", "192",
            "--height", "108", "--spp", "4", "--adaptive-spp", "--batch", "2",
            "--checkpoint", str(ck), "--checkpoint-every", "2"]
    before = dict(mk.KERNEL.variant_launches)
    assert main(args + ["--frames", "4"]) == 0
    assert main(args + ["--frames", "2", "--resume", "--out", str(out)]) == 0
    after = mk.KERNEL.variant_launches
    grew = {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}
    assert grew == {mk.variant("spheres", adaptive=True): 3 * 2}
    img = np.load(out)
    assert img.shape == (108, 192, 3) and np.isfinite(img).all()
    with np.load(ck) as z:
        assert int(z["frame"]) == 6


def test_mesh_command_on_the_card(cuda, tmp_path):
    """``render --scene preset:mesh`` and an ``.obj`` spec on the card: only
    the BVH instantiations launch."""
    from ray_tracing_extended_tpu_torch.cli import main
    from ray_tracing_extended_tpu_torch.scene.procedural import uv_sphere_mesh

    v, f = uv_sphere_mesh(16, 32)
    obj = tmp_path / "ball.obj"
    obj.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v)
                   + "".join(f"f {i + 1} {j + 1} {k + 1}\n" for i, j, k in f))
    before = dict(mk.KERNEL.variant_launches)
    for spec in ("preset:mesh", str(obj)):
        out = tmp_path / "out.npy"
        assert main(["render", "--scene", spec, "--width", "128", "--height",
                     "72", "--frames", "4", "--batch", "2", "--adaptive-spp",
                     "--out", str(out)]) == 0
        img = np.load(out)
        assert img.shape == (72, 128, 3) and np.isfinite(img).all()
    after = mk.KERNEL.variant_launches
    grew = {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}
    assert grew == {mk.variant("bvh", adaptive=True): 4 * 2}


def _band_scene(name, cuda, **small):
    if name == "rtiow":
        return _on(cuda, *presets.rtiow_final_scene(**small))
    return _on(cuda, *_triangle_scene(name, **small))


@pytest.mark.parametrize("adaptive", [False, True], ids=["exact", "refill"])
@pytest.mark.parametrize("name", ["rtiow", "cornell", "mesh"])
def test_band_launches_equal_whole_frame_launch(cuda, name, adaptive):
    """Band launches (a 1x4 mesh listing the card four times: bands of 16,
    16, 16 and 6 rows; refill on tiles of 16, the config's) of each
    geometry, stitched, against the whole-frame launch bit for bit: a frame
    with its total, and a 2-frame fold from a seeded accumulator with its
    per-pixel map and total; each band against
    render_frames_plain(rows=...) under bench.py's mb1 gate."""
    from ray_tracing_extended_tpu_torch.parallel import sharding as sh

    scene, cam, cfg = _band_scene(name, cuda, width=96, height=54, spp=2,
                                  max_bounce=1)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive,
                              mega_tile_size=16 if adaptive else None)
    variant = mk.variant(mk.geometry(scene, cfg), adaptive)
    mesh = sh.make_mesh([cuda] * 4)
    img, segs, _, _ = mk.render_frames_mega(scene, cam, cfg, 3)
    before = mk.KERNEL.variant_launches[variant]
    s_img, s_segs = sh.render_frame_mega_sharded(scene, cam, cfg, 3, mesh)
    assert mk.KERNEL.variant_launches[variant] == (
        before + 4 * mk.launches_per_call(cfg))
    assert torch.equal(s_img, img) and int(s_segs) == int(segs)

    gen = torch.Generator(device=cuda).manual_seed(0)
    acc0 = 2.0 * torch.rand((54, 96, 3), generator=gen, device=cuda)
    acc, total, seg_map, _ = mk.render_frames_mega(scene, cam, cfg, 2, 2,
                                                   accum=acc0)
    bands, b_total, maps = sh.render_frames_mega_sharded(
        scene, cam, cfg, 2, sh.image_to_bands(acc0, cfg, mesh), 2, mesh)
    assert [b.shape[0] for b in bands] == [16, 16, 16, 6]
    assert torch.equal(sh.mega_bands_to_image(bands, cfg), acc)
    assert torch.equal(torch.cat(maps), seg_map)
    assert int(b_total) == int(total) == int(seg_map.sum())
    for band, (y0, y1) in zip(bands, ((0, 16), (16, 32), (32, 48), (48, 54))):
        p = mk.render_frames_plain(scene, cam, cfg, 2, 2,
                                   accum=acc0[y0:y1].contiguous(),
                                   rows=(y0, y1))[0]
        _, median, channel = _gates(band, p)
        assert median < 2e-3 and channel < 5e-3, (y0, median, channel)


def test_band_launch_rules_on_the_card(cuda, tmp_path):
    """A refill band off the refill tiles' rows raises; a 2x2 mesh's frame
    is the mean of two launches bit for bit; ``make_mesh()`` takes every
    visible card; ``render --mesh`` needs as many cards as the mesh names
    and exits naming how many are visible, and ``--mesh 1x1`` is the render
    without a mesh."""
    from ray_tracing_extended_tpu_torch.cli import main
    from ray_tracing_extended_tpu_torch.ops import vecmath as vm
    from ray_tracing_extended_tpu_torch.parallel import sharding as sh

    scene, cam, cfg = _on(cuda, *presets.three_sphere_scene(
        width=40, height=24, spp=2))
    acfg = dataclasses.replace(cfg, adaptive_spp=True, mega_tile_size=16)
    for rows in ((4, 24), (8, 24), (0, 8)):
        with pytest.raises(ValueError, match="whole tiles"):
            mk.render_frames_mega(scene, cam, acfg, 0, rows=rows)
    whole = mk.render_frames_mega(scene, cam, acfg, 0)[0]
    assert torch.equal(mk.render_frames_mega(scene, cam, acfg, 0,
                                             rows=(16, 24))[0], whole[16:])
    img, segs = sh.render_frame_mega_sharded(
        scene, cam, cfg, 6, sh.make_mesh([cuda] * 4, spp_parallel=2))
    a0, s0, _, _ = mk.render_frames_mega(scene, cam, cfg, 6)
    a1, s1, _, _ = mk.render_frames_mega(scene, cam, cfg, 7)
    assert torch.equal(img, vm.div(a0 + a1, 2.0))
    assert int(segs) == int(s0) + int(s1)
    n = torch.cuda.device_count()
    assert sh.make_mesh().shape == {"spp": 1, "tiles": n}
    args = ["render", "--scene", "preset:three_sphere", "--width", "40",
            "--height", "24", "--frames", "2"]
    with pytest.raises(SystemExit, match=f"{n} visible"):
        main(args + ["--mesh", f"1x{max(4, n + 1)}"])
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    assert main(args + ["--mesh", "1x1", "--out", str(a)]) == 0
    assert main(args + ["--out", str(b)]) == 0
    np.testing.assert_array_equal(np.load(a), np.load(b))


def test_bvh_kernel_equals_chunk_scan(cuda):
    """The mesh through the BVH instantiation and through the chunk scan
    (``intersector="bruteforce"``): the same frame under the whole-frame
    rule (only exact ties could differ) and the same segment counts."""
    scene, cam, cfg = _on(cuda, *presets.mesh_scene(
        width=96, height=54, spp=2, target_tris=4000))
    scan_cfg = dataclasses.replace(cfg, intersector="bruteforce")
    assert mk.geometry(scene, scan_cfg) == "chunks"
    a, a_segs, a_map, _ = mk.render_frames_mega(scene, cam, cfg, 3)
    b, b_segs, b_map, _ = mk.render_frames_mega(scene, cam, scan_cfg, 3)
    d = (a - b).abs().amax(-1)
    assert float((d < 1e-3).double().mean()) > 0.995
    assert float((a - b).abs().mean()) < 1e-3
    assert int(a_segs) == int(b_segs) and torch.equal(a_map, b_map)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_bvh_kernel_equals_plain_bit_for_bit(cuda, adaptive, fast):
    """mesh_scene (70k triangles) at 192x108, 4 spp, depth 0, through each
    BVH instantiation: the kernel's traversal and the plain one visit the
    same nodes and triangles in the same order, so the image, the
    per-pixel segment map and the histogram are the plain version's bit for
    bit; the instantiation's launches counted (two with refill)."""
    scene, cam, cfg = presets.mesh_scene(width=192, height=108, spp=4,
                                         max_bounce=0)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive, fast_scatter=fast)
    name = mk.variant("bvh", adaptive, fast)
    assert mk.variant(mk.geometry(scene, cfg), adaptive, fast) == name
    before = mk.KERNEL.variant_launches[name]
    k, k_segs, k_map, k_hist = mk.render_frames_mega(scene, cam, cfg, 5,
                                                     collect_stats=True)
    p, p_segs, p_map, p_hist = mk.render_frames_plain(scene, cam, cfg, 5,
                                                      collect_stats=True)
    torch.cuda.synchronize()
    assert mk.KERNEL.variant_launches[name] == (
        before + mk.launches_per_call(cfg))
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    assert torch.equal(k_map, p_map) and torch.equal(k_hist, p_hist)
    assert int(k_segs) == int(p_segs) == 192 * 108 * 4
    assert mk.KERNEL.blocks_per_sm(scene, cfg) >= 1


def _uncull(scene, cfg):
    """The plain version's closest hit without the kernel's culls."""
    from ray_tracing_extended_tpu_torch.accel.bvh import closest_hit_bvh
    from ray_tracing_extended_tpu_torch.ops.intersect import (
        closest_hit_bruteforce,
    )

    return (closest_hit_bvh if mk.geometry(scene, cfg) == "bvh"
            else closest_hit_bruteforce)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("name", ["rtiow", "cornell", "chess", "mesh"])
def test_clustered_scan_against_plain_with_and_without_culls(cuda, name,
                                                             adaptive):
    """The redesigned scans: the plain path is ``closest_hit_clustered``
    (the kernel's function, culls included) and the kernel passes
    bench.py's gates against it; against the plain version without culls
    (brute-force scan; sphere scan and BVH for the mesh) it passes the same
    gates, and the segment totals of real pixels agree within 5e-3
    relative (the kernel tests in the direct o - c form, the plain version
    in the expanded one: they decide some grazing hits differently, culls
    or not). The culls themselves move almost nothing: the plain version
    with them against the one without, over 99.9% of pixels identical."""
    if name == "rtiow":
        scene, cam, cfg = presets.rtiow_final_scene(width=96, height=54, spp=4)
    else:
        scene, cam, cfg = _triangle_scene(name, width=96, height=54, spp=4)
    fn = mk.plain_intersector(scene, cam, cfg)
    assert fn.func is mk.closest_hit_clustered
    assert fn.keywords["tables"].geometry == mk.geometry(scene, cfg)
    still = cam.replace(defocus_strength=0.0)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive)
    for mb, c in ((0, still), (1, still), (4, cam)):
        cfg = dataclasses.replace(cfg, max_bounce=mb)
        k, _, k_map, _ = mk.render_frames_mega(scene, c, cfg, 5)
        p, _, p_map, _ = mk.render_frames_plain(scene, c, cfg, 5)
        u, _, u_map, _ = mk.render_frames_plain(
            scene, c, cfg, 5, intersect_fn=_uncull(scene, cfg))
        for ref, ref_map in ((p, p_map), (u, u_map)):
            exact, median, channel = _gates(k, ref)
            if mb == 0:
                assert exact > 0.85, exact
                assert torch.equal(k_map, ref_map)
            elif mb == 1:
                assert median < 2e-3 and channel < 5e-3, (median, channel)
            else:
                assert channel < 1e-2, channel
            total = int(ref_map.sum())
            assert abs(int(k_map.sum()) - total) <= 5e-3 * total
        assert float((p == u).all(dim=-1).double().mean()) > 0.999
        assert float((p_map == u_map).double().mean()) > 0.999


def _few_spheres_scene(n_spheres, triangles, device):
    from ray_tracing_extended_tpu_torch.models.scene import (
        Material,
        SceneBuilder,
    )

    b = SceneBuilder(env=presets._gradient_sky())
    for i in range(n_spheres):
        b.add_sphere((1.2 * i - 0.6, 0.0, 0.0), 0.5,
                     Material.lambertian((0.8, 0.3 + 0.4 * i, 0.2)))
    if triangles:
        # a floor quad facing up, as one chunk
        quad = np.array([[[-3, -0.5, -3], [-3, -0.5, 3], [3, -0.5, 3]],
                         [[-3, -0.5, -3], [3, -0.5, 3], [3, -0.5, -3]]],
                        np.float32)
        up = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (2, 3, 1))
        b.add_triangles(quad, up, Material.lambertian((0.5, 0.5, 0.5)))
    cam = rtt.look_at((0.0, 0.6, -3.0), (0.0, 0.0, 0.0), fov_y_deg=45.0,
                      focus_distance=3.0, defocus_strength=0.0,
                      diverge_strength=0.5, device=device)
    return b.build(device=device), cam


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("triangles", [False, True])
@pytest.mark.parametrize("n_spheres", [0, 2])
def test_zero_and_two_sphere_scenes(cuda, n_spheres, triangles, adaptive):
    """A scene without a sphere launches with no cluster and no sphere slot
    (the sky, or the floor alone); two spheres are one cluster of two live
    slots behind a tight box. Both against the plain version."""
    scene, cam = _few_spheres_scene(n_spheres, triangles, cuda)
    cfg = rtt.RenderConfig(width=64, height=40, spp=4, max_bounce=0,
                           adaptive_spp=adaptive)
    tab = mk.geometry_tables(scene, mk.geometry(scene, cfg))
    assert tab.spheres.shape == (n_spheres, 4) and tab.n_hoist == 0
    assert tab.clusters.shape[0] == (1 if n_spheres else 0)
    assert scene.spheres.count == 128  # the scene's own arrays stay padded
    for mb in (0, 3):
        cfg = dataclasses.replace(cfg, max_bounce=mb)
        k, k_segs, k_map, _ = mk.render_frames_mega(scene, cam, cfg, 2)
        p, _, p_map, _ = mk.render_frames_plain(scene, cam, cfg, 2)
        assert bool(torch.isfinite(k).all())
        exact, median, channel = _gates(k, p)
        if mb == 0:
            assert exact > 0.85, exact
            assert torch.equal(k_map, p_map)
        else:
            assert median < 2e-3 and channel < 5e-3, (median, channel)
        if n_spheres == 0 and not triangles:
            # nothing to hit: every sample is one segment of sky
            assert int(k_segs) == 64 * 40 * 4 and float(k.min()) > 0.0


def test_lower_scene_index_wins_a_tie_in_any_slot_order(cuda):
    """Twelve of 52 spheres repeat an earlier sphere with another colour;
    the kernel gives the earlier one's colour, as the plain version does,
    also when each cluster's slots are laid out in reverse, so that a
    repeat is tested before its original."""
    from ray_tracing_extended_tpu_torch.models.scene import (
        Material,
        SceneBuilder,
    )

    rs = np.random.RandomState(14)
    centres = rs.uniform(-2.0, 2.0, (40, 3)).astype(np.float32)
    b = SceneBuilder(env=presets._gradient_sky())
    for c in centres:
        b.add_sphere(c, 0.45, Material.lambertian((0.9, 0.1, 0.1)))
    for c in centres[:12]:
        b.add_sphere(c, 0.45, Material.lambertian((0.1, 0.1, 0.9)))
    scene = b.build(device=cuda)
    cam = rtt.look_at((0.0, 0.0, -8.0), (0.0, 0.0, 0.0), fov_y_deg=40.0,
                      focus_distance=8.0, defocus_strength=0.0,
                      diverge_strength=0.0, device=cuda)
    # one bounce: a hit pixel shows its sphere's colour under the sky
    cfg = rtt.RenderConfig(width=96, height=96, spp=1, max_bounce=1)
    p = mk.render_frames_plain(scene, cam, cfg, 0)[0]
    k, _, k_map, _ = mk.render_frames_mega(scene, cam, cfg, 0)
    _, median, channel = _gates(k, p)
    assert median < 2e-3 and channel < 5e-3, (median, channel)

    tab = mk.geometry_tables(scene, "spheres")
    bits = tab.clusters[:, [3, 7]].contiguous().view(torch.int32).cpu()
    order = list(range(tab.n_hoist))
    for first, n in bits.tolist():
        order += range(first + n - 1, first - 1, -1)
    order = torch.tensor(order, device=cuda)
    flipped = dataclasses.replace(
        tab, spheres=tab.spheres[order].contiguous(),
        sphere_orig=tab.sphere_orig[order].contiguous(),
        sphere_mat=tab.sphere_mat[order].contiguous())
    orig = flipped.sphere_orig.cpu().tolist()
    assert any(orig.index(i + 40) < orig.index(i) for i in range(12))
    scene.__dict__["_kernel_tables"]["spheres"] = flipped
    k2 = mk.render_frames_mega(scene, cam, cfg, 0)[0]
    assert torch.equal(k2, k)
    # a pixel whose camera ray hit a sphere traced a second segment; under
    # the sky a red sphere is redder than blue, and no blue repeat shows
    hit = k_map == 2
    assert int(hit.sum()) > 500
    for img in (k, k2):
        assert int((img[..., 2] > img[..., 0])[hit].sum()) == 0


def _scan_vs_plain(scene, cam, cfg, tables, rows=None):
    """The sphere kernel of ``cfg`` on the route ``tables`` against the
    plain version in the kernel's test forms: a frame's image, segment map
    and histogram, and a K = 3 fold from a seeded accumulator in both clamp
    modes, bit for bit; over the band ``rows`` where given. One launch of
    the instantiation a call."""
    v = mk.variant("spheres", cfg.adaptive_spp, cfg.fast_scatter,
                   tables=tables)
    fn = mk.plain_intersector(scene, cam, cfg, direct=True)
    before = mk.KERNEL.variant_launches[v]
    k_img, k_segs, k_map, k_hist = mk.render_frames_mega(
        scene, cam, cfg, 5, collect_stats=True, rows=rows, tables=tables)
    p_img, _, p_map, p_hist = mk.render_frames_plain(
        scene, cam, cfg, 5, collect_stats=True, rows=rows, intersect_fn=fn)
    assert _bits_equal(k_img, p_img)
    assert torch.equal(k_map, p_map) and torch.equal(k_hist, p_hist)
    assert int(k_segs) == int(k_map.sum())
    h = cfg.height if rows is None else rows[1] - rows[0]
    gen = torch.Generator(device=k_img.device).manual_seed(11)
    acc0 = 2.0 * torch.rand((h, cfg.width, 3), generator=gen,
                            device=k_img.device)
    for clamp in (False, True):
        ccfg = dataclasses.replace(cfg, clamp_accumulate=clamp)
        k, _, k_map, _ = mk.render_frames_mega(
            scene, cam, ccfg, 2, 3, accum=acc0, rows=rows, tables=tables)
        p, _, p_map, _ = mk.render_frames_plain(
            scene, cam, ccfg, 2, 3, accum=acc0, rows=rows, intersect_fn=fn)
        assert _bits_equal(k, p) and torch.equal(k_map, p_map)
    torch.cuda.synchronize()
    assert mk.KERNEL.variant_launches[v] == (
        before + 3 * mk.launches_per_call(cfg))
    return k_map


def _stacked_spheres_scene(device):
    """40 coincident spheres (one centre and radius, 40 colours), five more
    coincident at a second centre, and 30 scattered ones: the packer puts
    the 40 in two clusters and the five in one of 16 spheres, beside one
    of 27; the lower scene index must win every tie."""
    from ray_tracing_extended_tpu_torch.models.scene import (
        Material,
        SceneBuilder,
    )

    rs = np.random.RandomState(3)
    b = SceneBuilder(env=presets._gradient_sky())
    for i in range(40):
        b.add_sphere((0.0, 0.0, 0.0), 0.6,
                     Material.lambertian((0.1 + 0.02 * i, 0.5, 0.2)))
    for c in rs.uniform(-3.0, 3.0, (30, 3)):
        b.add_sphere(c, 0.3, Material.lambertian((0.2, 0.3, 0.9)))
    for i in range(5):
        b.add_sphere((1.5, 0.5, 0.0), 0.4,
                     Material.metal((0.9, 0.2 * i, 0.1), smoothness=0.7))
    cam = rtt.look_at((0.5, 1.0, -6.0), (0.5, 0.2, 0.0), fov_y_deg=50.0,
                      focus_distance=6.0, defocus_strength=0.0,
                      diverge_strength=0.3, device=device)
    return b.build(device=device), cam


SCAN_MODES = [(a, f, t) for a in (False, True) for f in (False, True)
              for t in mk.TABLES]
SCAN_IDS = [f"{'refill' if a else 'exact'}-{'fast' if f else 'bm'}-{t}"
            for a, f, t in SCAN_MODES]


@pytest.mark.parametrize("adaptive, fast, tables", SCAN_MODES, ids=SCAN_IDS)
def test_warp_scan_on_short_clusters_and_coincident_spheres(
        cuda, adaptive, fast, tables):
    """The warp-cooperative cluster scan where a cluster holds fewer than
    32 spheres (lanes without a sphere) and where coincident spheres tie
    exactly in one cluster and across two: both kernels, both scatters,
    both table routes, bit for bit the plain version."""
    scene, cam = _stacked_spheres_scene(cuda)
    tab = mk.geometry_tables(scene, "spheres")
    bits = tab.clusters[:, [3, 7]].contiguous().view(torch.int32).cpu()
    sizes = bits[:, 1].tolist()
    assert min(sizes) < 32 and max(sizes) <= 32
    cluster_of = {}
    for k, (first, n) in enumerate(bits.tolist()):
        for i in tab.sphere_orig[first:first + n].tolist():
            cluster_of[i] = k
    assert len({cluster_of[i] for i in range(40)}) == 2
    assert len({cluster_of[i] for i in range(70, 75)}) == 1
    cfg = rtt.RenderConfig(width=96, height=54, spp=2, max_bounce=4,
                           adaptive_spp=adaptive, fast_scatter=fast)
    k_map = _scan_vs_plain(scene, cam, cfg, tables)
    assert int((k_map > cfg.spp).sum()) > 500  # camera rays that hit a sphere


def _surface_camera_scene(device, inside):
    """Two coincident unit spheres at the origin (a lambertian one, then a
    glass one), a glass sphere and a metal one beside them, over a ground
    sphere; the camera sits inside the unit spheres, or on their surface,
    looking in, so that its rays' roots there are exactly 0."""
    from ray_tracing_extended_tpu_torch.models.scene import (
        Material,
        SceneBuilder,
    )

    b = SceneBuilder(env=presets._gradient_sky())
    b.add_sphere((0.0, 0.0, 0.0), 1.0, Material.lambertian((0.8, 0.3, 0.3)))
    b.add_sphere((0.0, 0.0, 0.0), 1.0, Material.dielectric(1.5))
    b.add_sphere((1.6, 0.0, 1.0), 0.6, Material.dielectric(1.5))
    b.add_sphere((-1.6, 0.0, 1.0), 0.6, Material.metal((0.7, 0.7, 0.9), 0.9))
    b.add_sphere((0.0, -101.0, 0.0), 100.0,
                 Material.lambertian((0.5, 0.5, 0.5)))
    z = -0.5 if inside else -1.0
    cam = rtt.look_at((0.0, 0.0, z), (0.0, 0.0, 2.0), fov_y_deg=70.0,
                      focus_distance=2.0, defocus_strength=0.0,
                      diverge_strength=0.0, device=device)
    return b.build(device=device), cam


@pytest.mark.parametrize("adaptive, fast, tables", SCAN_MODES, ids=SCAN_IDS)
@pytest.mark.parametrize("inside", [True, False], ids=["inside", "surface"])
def test_warp_scan_with_the_camera_in_a_sphere(cuda, inside, adaptive, fast,
                                               tables):
    """A camera inside a sphere (every root of it behind the origin) and on
    its surface (the roots of the rays into it are 0, a tie between the
    two coincident spheres there): both kernels, both scatters, both
    table routes, bit for bit the plain version."""
    scene, cam = _surface_camera_scene(cuda, inside)
    cfg = rtt.RenderConfig(width=96, height=54, spp=2, max_bounce=4,
                           adaptive_spp=adaptive, fast_scatter=fast)
    _scan_vs_plain(scene, cam, cfg, tables)


@pytest.mark.parametrize("adaptive, fast, tables", SCAN_MODES, ids=SCAN_IDS)
def test_warp_scan_band_with_lanes_outside_the_image(cuda, adaptive, fast,
                                                     tables):
    """RTIOW 96x54 on a band launch whose last warps reach past the band
    (exact: rows 10-26, a warp with one row in and one out; refill, on
    tiles of 16: rows 16 to the end, whose last block rows lie past the
    frame): their lanes cast every vote of the scan and hold spheres in
    it. Both kernels, both scatters, both table routes, bit for bit the
    plain version's band."""
    scene, cam, cfg = presets.rtiow_final_scene(width=96, height=54, spp=2,
                                                max_bounce=4, device=cuda)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive, fast_scatter=fast,
                              mega_tile_size=16 if adaptive else None)
    rows = (16, 54) if adaptive else (10, 27)
    _scan_vs_plain(scene, cam, cfg, tables, rows=rows)


def _sphere_scan_case(name, cuda, adaptive, fast):
    """A sphere scene for the kSpheres cluster scan -> ``(scene, camera,
    config, rows)``, 2 spp, 4 bounces: RTIOW 96x54; the RTIOW rule over an
    80 x 80 grid (``supers``: 6,401 spheres, staged, a super box over each
    run of 32 clusters); RTIOW at 250x134 (``edges``: the last column of
    blocks holds 10 columns, the last row 6 rows); RTIOW 192x108 on a band
    (``band``: rows 37-100 exact, 32-95 with refill on tiles of 32)."""
    from ray_tracing_extended_tpu_torch.models.wide_scenes import (
        wide_sphere_scene,
    )

    small = dict(spp=2, max_bounce=4, device=cuda)
    rows, ts = None, None
    if name == "supers":
        scene, cam, cfg = wide_sphere_scene(presets, 40, width=96, height=54,
                                            **small)
    elif name == "edges":
        scene, cam, cfg = presets.rtiow_final_scene(width=250, height=134,
                                                    **small)
    elif name == "band":
        scene, cam, cfg = presets.rtiow_final_scene(width=192, height=108,
                                                    **small)
        rows, ts = ((32, 96), 32) if adaptive else ((37, 101), None)
    else:
        scene, cam, cfg = presets.rtiow_final_scene(width=96, height=54,
                                                    **small)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive, fast_scatter=fast,
                              mega_tile_size=ts)
    return scene, cam, cfg, rows


SPHERE_SCAN_MODES = (
    [("rtiow", a, f, t) for a, f, t in SCAN_MODES]
    + [(n, a, f, t) for n in ("supers", "edges", "band")
       for a in (False, True) for f in (False, True) for t in mk.TABLES
       if not (n == "supers" and (f or t == "global"))])


@pytest.mark.parametrize(
    "name, adaptive, fast, tables", SPHERE_SCAN_MODES,
    ids=[f"{n}-{'refill' if a else 'exact'}-{'fast' if f else 'bm'}-{t}"
         for n, a, f, t in SPHERE_SCAN_MODES])
def test_sphere_scan_cases_equal_plain_bit_for_bit(cuda, name, adaptive,
                                                   fast, tables):
    """The kSpheres instantiations' cluster scan (across the warp, the
    per-lane loop for a visit of many lanes) on the cases a scan that
    shares a cluster's rays across a block's warps has to hold: RTIOW in
    both kernels, both scatters, both table routes; a staged scene with
    supers; a frame whose edges cut blocks; a band launch from a row past
    0. A frame's image, segment map and histogram and a K = 3 fold in both
    clamp modes, bit for bit the plain version in the kernel's test forms;
    the route the test asks for is the launch's."""
    scene, cam, cfg, rows = _sphere_scan_case(name, cuda, adaptive, fast)
    if name == "supers":
        tab = mk.geometry_tables(scene, "spheres")
        assert tab.sph_supers.shape[0] > 1
        assert mk.table_route(tab, cfg) == "staged"
    k_map = _scan_vs_plain(scene, cam, cfg, tables, rows=rows)
    assert int(k_map.sum()) > 0


# refill's lane-knob settings (pixels a lane, phases, a cost pairing), as
# chip_smoke.py's KNOB_SETTINGS
SPHERE_KNOB_SETTINGS = ((2, 1, False), (4, 1, False), (1, 2, False),
                        (2, 2, False), (2, 1, True))


@pytest.mark.parametrize("ppl, phases, paired", SPHERE_KNOB_SETTINGS,
                         ids=[f"ppl{p}-ph{h}{'-paired' if c else ''}"
                              for p, h, c in SPHERE_KNOB_SETTINGS])
def test_sphere_scan_refill_knobs_equal_plain_bit_for_bit(cuda, ppl, phases,
                                                          paired):
    """render_adaptive<kSpheres, kBoxMuller, kKnobs>'s cluster scan under
    each lane-knob setting, on the staged scene with supers at
    250x134 (edges that cut blocks and tiles of 32): phase 1's segment and
    slot maps and each tile's last finish equal as integers, and the image,
    segment map and histogram bit for bit the plain version's two phases;
    the launches counted."""
    from ray_tracing_extended_tpu_torch.models.wide_scenes import (
        wide_sphere_scene,
    )

    scene, cam, cfg = wide_sphere_scene(
        presets, 40, width=250, height=134, spp=2, max_bounce=4, device=cuda)
    cfg = dataclasses.replace(cfg, adaptive_spp=True, mega_tile_size=32,
                              mega_pixels_per_lane=ppl, mega_phases=phases)
    v = mk.variant("spheres", True, knobs=True)
    assert mk.path_name(scene, cfg) == v
    costs = None
    if paired:
        gen = torch.Generator(device=cuda).manual_seed(8)
        costs = torch.randint(0, 40, (134, 250), generator=gen, device=cuda,
                              dtype=torch.int32)
    before = mk.KERNEL.variant_launches[v]
    k_one, p_one = {}, {}
    k = mk.render_frames_mega(scene, cam, cfg, 3, collect_stats=True,
                              phase_one=k_one, pair_costs=costs)
    p = mk.render_frames_plain(
        scene, cam, cfg, 3, collect_stats=True, phase_one=p_one,
        pair_costs=costs,
        intersect_fn=mk.plain_intersector(scene, cam, cfg, direct=True))
    for key in ("segs", "slots", "tile_max"):
        assert torch.equal(k_one[key], p_one[key].to(cuda)), key
    assert _bits_equal(k[0], p[0])
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    torch.cuda.synchronize()
    assert mk.KERNEL.variant_launches[v] == before + 2


def _off_tile_scene(name, cuda):
    """A scene at 250x134 (no multiple of the 16x2 warp or the 16x8 block:
    the last column of blocks holds 10 columns, the last row 6 rows), 2
    spp, 4 bounces: RTIOW and the 14,401-sphere wide scene (kSpheres),
    Chess (its shipped camera and defocus), Cornell and ``tiles``, a scene
    of SUPER_CHUNKS squared + 1 chunks, the fewest with two box levels
    (``tests/chunk_scenes.py``; kChunks)."""
    from ray_tracing_extended_tpu_torch.models.wide_scenes import (
        HALF_PAST_LIMIT,
        wide_sphere_scene,
    )

    small = dict(width=250, height=134, spp=2, max_bounce=4)
    if name == "tiles":
        from chunk_scenes import tile_scene

        return tile_scene(mk.SUPER_CHUNKS ** 2 + 1, device=cuda, **small)
    if name == "rtiow":
        return presets.rtiow_final_scene(device=cuda, **small)
    if name == "wide":
        return wide_sphere_scene(presets, HALF_PAST_LIMIT, device=cuda,
                                 **small)
    return _triangle_scene(name, device=cuda, **small)


OFF_TILE_MODES = [(n, f, t) for n in ("rtiow", "chess", "cornell", "wide")
                  for f in (False, True) for t in mk.TABLES
                  if not (n == "wide" and t == "staged")]


@pytest.mark.parametrize("name, fast, tables", OFF_TILE_MODES,
                         ids=[f"{n}-{'fast' if f else 'bm'}-{t}"
                              for n, f, t in OFF_TILE_MODES])
def test_exact_kernel_off_the_tile_grid(cuda, name, fast, tables):
    """render_kernel's kSpheres and kChunks instantiations, both scatters
    and both routes, on a frame whose edges cut warps and blocks: a
    frame's image, segment map and histogram equal the plain version's bit
    for bit (its kernel test forms); three K = 3 folds from a seeded
    accumulator in a row are equal, histograms too; a band launch with odd
    row bounds equals those rows of the whole frame's. Launches
    counted."""
    scene, cam, cfg = _off_tile_scene(name, cuda)
    cfg = dataclasses.replace(cfg, fast_scatter=fast)
    geom = mk.geometry(scene, cfg)
    assert geom in ("spheres", "chunks")
    v = mk.variant(geom, fast_scatter=fast, tables=tables)
    before = mk.KERNEL.variant_launches[v]
    k_img, _, k_map, k_hist = mk.render_frames_mega(
        scene, cam, cfg, 5, collect_stats=True, tables=tables)
    p_img, _, p_map, p_hist = mk.render_frames_plain(
        scene, cam, cfg, 5, collect_stats=True,
        intersect_fn=mk.plain_intersector(scene, cam, cfg, direct=True))
    assert _bits_equal(k_img, p_img)
    assert torch.equal(k_map, p_map) and torch.equal(k_hist, p_hist)
    gen = torch.Generator(device=cuda).manual_seed(5)
    acc0 = 2.0 * torch.rand((cfg.height, cfg.width, 3), generator=gen,
                            device=cuda)

    def fold(rows=None):
        sl = slice(None) if rows is None else slice(*rows)
        img, segs, seg_map, hist = mk.render_frames_mega(
            scene, cam, cfg, 2, 3, accum=acc0[sl].contiguous(),
            collect_stats=True, rows=rows, tables=tables)
        return img, int(segs), seg_map, hist

    first = fold()
    for out in (fold(), fold()):
        assert _bits_equal(out[0], first[0])
        assert out[1] == first[1]
        assert torch.equal(out[2], first[2]) and torch.equal(out[3], first[3])
    band = fold(rows=(37, 101))
    assert _bits_equal(band[0], first[0][37:101])
    assert torch.equal(band[2], first[2][37:101])
    assert band[1] == int(first[2][37:101].sum())
    torch.cuda.synchronize()
    assert mk.KERNEL.variant_launches[v] == before + 5


REFILL_PHASE_MODES = [(n, f, ts) for n in ("rtiow", "cornell", "chess")
                      for f in (False, True) for ts in (None, 32)]


@pytest.mark.parametrize("name, fast, ts", REFILL_PHASE_MODES,
                         ids=[f"{n}-{'fast' if f else 'bm'}-{ts or 'auto'}"
                              for n, f, ts in REFILL_PHASE_MODES])
def test_refill_phases_equal_plain_bit_for_bit(cuda, name, fast, ts):
    """render_adaptive's two launches against the plain version's two
    phases (its kernel test forms, so both trace the same paths) on a
    250x134 frame, whose edges cut warps, blocks and tiles (the scene's
    tiles of 128, or the config's 32): phase 1's segment map and each
    tile's last finish equal as integers, and the image, segment map and
    histogram bit for bit; a frame, and a K = 3 fold from a seeded
    accumulator, the latter on a band of whole tiles with tiles of 32.
    Both launches counted, and timed by their events."""
    scene, cam, cfg = _off_tile_scene(name, cuda)
    cfg = dataclasses.replace(cfg, adaptive_spp=True, fast_scatter=fast,
                              mega_tile_size=ts)
    fn = mk.plain_intersector(scene, cam, cfg, direct=True)
    v = mk.variant(mk.geometry(scene, cfg), True, fast)
    rows = (32, 96) if ts else None
    gen = torch.Generator(device=cuda).manual_seed(6)
    acc0 = 2.0 * torch.rand((64 if ts else 134, 250, 3), generator=gen,
                            device=cuda)
    before = mk.KERNEL.variant_launches[v]
    for frame0, n, acc, band in ((5, 1, None, None), (2, 3, acc0, rows)):
        k_one, p_one = {}, {}
        k = mk.render_frames_mega(scene, cam, cfg, frame0, n, accum=acc,
                                  collect_stats=True, rows=band,
                                  phase_one=k_one)
        p = mk.render_frames_plain(scene, cam, cfg, frame0, n, accum=acc,
                                   collect_stats=True, rows=band,
                                   intersect_fn=fn, phase_one=p_one)
        assert torch.equal(k_one["segs"], p_one["segs"].to(cuda))
        assert torch.equal(k_one["tile_max"], p_one["tile_max"].to(cuda))
        assert _bits_equal(k[0], p[0])
        assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
        assert int(k[1]) == int(k[2].sum()) > int(k_one["segs"].sum())
        e = k_one["events"]
        torch.cuda.synchronize()
        assert e[0].elapsed_time(e[1]) > 0 and e[2].elapsed_time(e[3]) > 0
    assert mk.KERNEL.variant_launches[v] == before + 4


# (scene, pixels a lane, phases, cost map, fast scatter, route, tile side)
KNOB_MODES = [
    ("rtiow", 2, 1, False, False, "staged", None),
    ("rtiow", 4, 1, False, False, "staged", None),
    ("rtiow", 1, 2, False, False, "staged", None),
    ("rtiow", 2, 2, False, False, "staged", 32),
    ("rtiow", 2, 1, True, False, "staged", 32),
    ("rtiow", 2, 2, True, True, "global", None),
    ("rtiow", 2, 1, False, True, "staged", None),
    ("rtiow", 1, 2, False, False, "global", 32),
    ("cornell", 2, 1, False, False, "staged", None),
    ("cornell", 4, 1, True, False, "staged", 32),
    ("cornell", 1, 2, False, False, "staged", 32),
    ("cornell", 2, 2, True, True, "global", None),
    ("cornell", 2, 1, False, True, "staged", 32),
    ("chess", 2, 2, True, False, "staged", None),
    ("chess", 1, 2, False, True, "global", 32),
]


@pytest.mark.parametrize(
    "name, ppl, phases, costs, fast, tables, ts", KNOB_MODES,
    ids=[f"{n}-ppl{p}-ph{h}{'-paired' if c else ''}-{'fast' if f else 'bm'}"
         f"-{t}-{ts or 'auto'}" for n, p, h, c, f, t, ts in KNOB_MODES])
def test_refill_knobs_equal_plain_bit_for_bit(cuda, name, ppl, phases, costs,
                                              fast, tables, ts):
    """render_adaptive under the lane knobs (its kKnobs instantiation; with
    more than one pixel a lane the lane pass between its launches) against
    the plain version's two phases (its kernel test forms) on a 250x134
    frame, whose edges cut warps, blocks and tiles: phase 1's segment and
    slot maps and each tile's last finish equal as integers, and the image,
    segment map and histogram bit for bit; a frame, and a K = 3 fold from a
    seeded accumulator, the latter on a band of whole tiles with tiles of
    32; with a seeded cost map pairing a lane's pixels. With more than one
    pixel a lane also the lane pass's resume map and list as integers:
    phase 2 runs over the list. Every launch counted."""
    scene, cam, cfg = _off_tile_scene(name, cuda)
    cfg = dataclasses.replace(cfg, adaptive_spp=True, fast_scatter=fast,
                              mega_tile_size=ts, mega_pixels_per_lane=ppl,
                              mega_phases=phases)
    fn = mk.plain_intersector(scene, cam, cfg, direct=True)
    v = mk.variant(mk.geometry(scene, cfg), True, fast, tables=tables,
                   knobs=True)
    assert mk.knobbed(scene, cfg)
    rows = (32, 96) if ts else None
    gen = torch.Generator(device=cuda).manual_seed(7)
    acc0 = 2.0 * torch.rand((64 if ts else 134, 250, 3), generator=gen,
                            device=cuda)
    cmap = torch.randint(0, 40, (134, 250), generator=gen, device=cuda,
                         dtype=torch.int32)
    before = (mk.KERNEL.variant_launches[v],
              mk.KERNEL.variant_launches[mk.LANE_PASS])
    for frame0, n, acc, band in ((5, 1, None, None), (2, 3, acc0, rows)):
        c = None
        if costs:
            c = cmap if band is None else cmap[slice(*band)].contiguous()
        k_one, p_one = {}, {}
        k = mk.render_frames_mega(scene, cam, cfg, frame0, n, accum=acc,
                                  collect_stats=True, rows=band,
                                  phase_one=k_one, tables=tables,
                                  pair_costs=c)
        p = mk.render_frames_plain(scene, cam, cfg, frame0, n, accum=acc,
                                   collect_stats=True, rows=band,
                                   intersect_fn=fn, phase_one=p_one,
                                   pair_costs=c)
        listed = ("resume", "lane_list") if ppl > 1 else ()
        assert sorted(k_one) == sorted(("segs", "slots", "tile_max",
                                        "events") + listed)
        for key in ("segs", "slots", "tile_max") + listed:
            assert torch.equal(k_one[key], p_one[key].to(cuda)), key
        assert _bits_equal(k[0], p[0])
        assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
        assert int(k[1]) == int(k[2].sum())
    torch.cuda.synchronize()
    assert mk.KERNEL.variant_launches[v] == before[0] + 4
    assert mk.KERNEL.variant_launches[mk.LANE_PASS] == before[1] + (
        2 if ppl > 1 else 0)


@pytest.mark.parametrize("ppl, phases, fast, tables", [
    (2, 2, False, "staged"), (4, 1, True, "staged"), (2, 1, False, "global"),
    (1, 2, True, "global")])
def test_bvh_refill_knobs_equal_plain_bit_for_bit(cuda, ppl, phases, fast,
                                                  tables):
    """The BVH's kKnobs instantiations, on both table routes, as
    test_bvh_kernel_equals_plain_bit_for_bit holds their twins: mesh_scene
    at 192x108, 4 spp, depth 0; each launch counted."""
    scene, cam, cfg = presets.mesh_scene(width=192, height=108, spp=4,
                                         max_bounce=0)
    cfg = dataclasses.replace(cfg, adaptive_spp=True, fast_scatter=fast,
                              mega_pixels_per_lane=ppl, mega_phases=phases)
    v = mk.variant("bvh", True, fast, tables=tables, knobs=True)
    before = mk.KERNEL.variant_launches[v]
    k_one, p_one = {}, {}
    k = mk.render_frames_mega(scene, cam, cfg, 5, collect_stats=True,
                              phase_one=k_one, tables=tables)
    p = mk.render_frames_plain(scene, cam, cfg, 5, collect_stats=True,
                               phase_one=p_one)
    listed = ("resume", "lane_list") if ppl > 1 else ()
    for key in ("segs", "slots", "tile_max") + listed:
        assert torch.equal(k_one[key], p_one[key].to(cuda)), key
    assert _bits_equal(k[0], p[0])
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    torch.cuda.synchronize()
    assert mk.KERNEL.variant_launches[v] == before + 2


def test_lane_pass_kernel_equals_plain(cuda):
    """The refill_lanes kernel, a block a tile, against its plain version on
    the CPU: a seeded slot map of a 250x134 frame, whose right and bottom
    edges cut tiles, two, four and eight pixels a lane, one and two phases,
    with and without a cost pairing, the whole frame and a band of whole
    tiles: the resume map, the tile maxima and the lane list as
    integers."""
    gen = torch.Generator().manual_seed(3)
    slots = torch.randint(1, 200, (134, 250), generator=gen,
                          dtype=torch.int32)
    costs = torch.randint(0, 50, (134, 250), generator=gen, dtype=torch.int32)
    before = mk.KERNEL.variant_launches[mk.LANE_PASS]
    calls = 0
    for ts, ppl, phases, paired in ((128, 2, 1, False), (128, 4, 2, True),
                                    (128, 8, 2, True), (32, 2, 2, True),
                                    (32, 8, 1, False), (64, 1, 2, False)):
        for rows in [(0, 134)] + ([(32, 96)] if ts == 32 else []):
            band = slice(*rows)
            perm = (mk.pair_perm(costs[band], 250, 134, ts, ppl, *rows)
                    if paired else None)
            want = mk.refill_lanes(slots[band].contiguous(), 250, 134, ts,
                                   ppl, phases, rows, perm)
            pix, inside = mk.tile_lanes(250, 134, ts, ppl, *rows, perm)
            want += (mk.refill_lane_list(pix, inside, 250, ts, rows[0]),)
            n_tiles = -(-(rows[1] - rows[0]) // ts) * -(-250 // ts)
            got = (torch.empty((rows[1] - rows[0], 250), dtype=torch.int32,
                               device=cuda),
                   torch.empty(n_tiles, dtype=torch.int32, device=cuda),
                   torch.empty(n_tiles * (ts * ts // ppl), dtype=torch.int32,
                               device=cuda))
            mk.KERNEL.lane_pass(
                slots[band].contiguous().to(cuda), *got, 250, 134, ts, ppl,
                phases, rows,
                None if perm is None else perm.to(cuda).contiguous())
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
            calls += 1
    torch.cuda.synchronize()
    assert mk.KERNEL.variant_launches[mk.LANE_PASS] == before + calls


def _production_ptxas(log):
    """``tools/scan_ab.py``'s ``ptxas -v`` of the production library, by
    ``mk.variant`` name as ``mk.PTXAS_PRODUCTION`` keys it (scan_ab's entry
    names give geometry, scatter, the global route, the lane knobs)."""
    from ray_tracing_extended_tpu_torch.tools import scan_ab

    out = {}
    for key, value in scan_ab._ptxas(log).items():
        m = re.fullmatch(r"(render_\w+)<(\d),(\d)((?:,\w+)*)>", key)
        kernel, flags = m.group(1), m.group(4).split(",")[1:]
        name = mk.variant(mk.GEOMETRIES[int(m.group(2))],
                          kernel != "render_kernel", m.group(3) == "1",
                          tables="global" if "global" in flags else "staged",
                          knobs="knobs" in flags or kernel == "render_listed")
        if kernel == "render_listed":
            name = name.replace("render_adaptive", "render_listed")
        out[name] = tuple(value)
    return out


def test_default_instantiations_keep_their_ptxas_pins(cuda):
    """The lane list lives in the kKnobs instantiations only: every staged
    production instantiation, the default refill's among them, keeps its
    pinned ``ptxas -v``."""
    got = _production_ptxas(mk.KERNEL.build().log)
    assert {v: got[v] for v in mk.VARIANTS} == {
        v: mk.PTXAS_PRODUCTION[v] for v in mk.VARIANTS}


def test_refill_knobs_refusals(cuda):
    """The profiling instantiations take the lane knobs (their ``kKnobs``
    instantiation renders its production twin's frame), and the kernel's
    rule refuses a pixel count a lane that does not divide its tile's rows
    of 128 (tiles of 16: two rows)."""
    scene, cam, cfg = presets.three_sphere_scene(width=64, height=32, spp=1)
    cfg = dataclasses.replace(cfg, adaptive_spp=True, mega_pixels_per_lane=2)
    ref = mk.render_frames_mega(scene, cam, cfg, 1)
    out = mk.render_frames_mega(scene, cam, cfg, 1, probe="dup_intersect")
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    with pytest.raises(ValueError, match="must divide the tile's 2 rows"):
        mk.render_frames_mega(scene, cam, dataclasses.replace(
            cfg, mega_tile_size=16, mega_pixels_per_lane=4), 1)


CHUNK_BAND_MODES = [(n, a, f, t) for n in ("chess", "cornell", "tiles")
                    for a in (False, True) for f in (False, True)
                    for t in mk.TABLES]


@pytest.mark.parametrize("name, adaptive, fast, tables", CHUNK_BAND_MODES,
                         ids=[f"{n}-{'refill' if a else 'exact'}-"
                              f"{'fast' if f else 'bm'}-{t}"
                              for n, a, f, t in CHUNK_BAND_MODES])
def test_chunk_scan_bands_equal_plain_bit_for_bit(cuda, name, adaptive, fast,
                                                  tables):
    """The warp-cooperative chunk scan computes the per-lane scan's
    function, which the plain version computes (its kernel test forms): on
    a band of a 250x134 frame whose edges cut warps (exact: rows 37-100;
    refill on tiles of 32: rows 32-95), Chess (its shipped camera, 440
    chunks under two box levels), Cornell (six chunks of two triangles, no
    box level) and ``tiles`` (SUPER_CHUNKS squared + 1 chunks: two levels,
    the top one over a run of one box), each kChunks instantiation's frame,
    segment map and histogram, and a K = 3 fold from a seeded accumulator,
    bit for bit the plain version's."""
    scene, cam, cfg = _off_tile_scene(name, cuda)
    n_chunks = scene.chunks.num_tris.shape[0]
    assert [len(x) for x in mk.chunk_box_levels(
        mk.geometry_tables(scene, "chunks").supers, n_chunks)] == [
            k for k in mk.super_levels(n_chunks) if k]
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive, fast_scatter=fast,
                              mega_tile_size=32 if adaptive else None)
    assert mk.geometry(scene, cfg) == "chunks"
    rows = (32, 96) if adaptive else (37, 101)
    fn = mk.plain_intersector(scene, cam, cfg, direct=True)
    k = mk.render_frames_mega(scene, cam, cfg, 5, collect_stats=True,
                              rows=rows, tables=tables)
    p = mk.render_frames_plain(scene, cam, cfg, 5, collect_stats=True,
                               rows=rows, intersect_fn=fn)
    assert _bits_equal(k[0], p[0])
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    gen = torch.Generator(device=cuda).manual_seed(7)
    acc0 = 2.0 * torch.rand((64, 250, 3), generator=gen, device=cuda)
    k = mk.render_frames_mega(scene, cam, cfg, 2, 3, accum=acc0, rows=rows,
                              tables=tables)
    p = mk.render_frames_plain(scene, cam, cfg, 2, 3, accum=acc0, rows=rows,
                               intersect_fn=fn)
    assert _bits_equal(k[0], p[0]) and torch.equal(k[2], p[2])


def test_resident_warps_hold_the_cards_blocks(cuda):
    """The warps a resident grid would hold for a whole-frame launch (the
    queue schedule's, ``warp_schedule_counts``): the card's SMs times the
    instantiation's blocks an SM times 4 at 1080p; a frame of fewer tiles
    than that holds one warp a tile, rounded up to whole blocks."""
    scene, cam, cfg = presets.rtiow_final_scene(width=1920, height=1080,
                                                device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    per_sm = mk.KERNEL.blocks_per_sm(scene, cfg)
    assert per_sm >= 1
    assert mk.KERNEL.resident_warps(scene, cfg) == 4 * sms * per_sm
    small = dataclasses.replace(cfg, width=250, height=134)
    assert mk.KERNEL.resident_warps(scene, small) == 4 * -(-16 * 67 // 4)


def test_vpu_kernel_matches_plain(cuda):
    """The vpu probe's kernel against its plain version on the card, bit for
    bit, at a reduced step count; one launch counted."""
    before = vpu.LAUNCHES["vpu_roofline"]
    k = vpu.vpu_chain(n_steps=300, grid=8, device=cuda)
    p = vpu.vpu_chain_plain(n_steps=300, grid=8, device=cuda)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    assert vpu.LAUNCHES["vpu_roofline"] == before + 1
    cpu = vpu.vpu_chain_plain(n_steps=300, grid=8)
    assert torch.equal(k.cpu(), cpu)


@pytest.mark.parametrize("variant", pairblock.VARIANTS)
def test_pairblock_kernel_matches_plain(cuda, variant):
    """Each pair-block variant's kernel against the plain version on the
    same CUDA tensors, bit for bit, one launch counted each: steps 1 and 3
    (fewer than the kernel's kSplit threads a ray), kSplit + 1 (a remainder)
    and the tool's 64, on grids of 1 and 2."""
    split = int(re.search(r"constexpr int kSplit = (\d+);",
                          pairblock.LIBRARY.source.read_text()).group(1))
    rays, cols = (torch.from_numpy(a).to(cuda) for a in pairblock.make_inputs())
    before = pairblock.LAUNCHES[variant]
    cases = [(steps, grid) for steps in (1, 3, split + 1, pairblock.STEPS)
             for grid in (1, 2)]
    for steps, grid in cases:
        k = pairblock.pairblock(rays, cols, variant, steps=steps, grid=grid)
        p = pairblock.pairblock_plain(rays, cols, variant, steps=steps,
                                      grid=grid)
        assert k.shape == (8 * grid, 128)
        assert torch.equal(k.view(torch.int32), p.view(torch.int32)), (
            steps, grid)
    assert pairblock.LAUNCHES[variant] == before + len(cases)


# ---- the scene entry: native LBVH, FBX and Unity scenes, compare, debug ----
def test_mesh_scene_builds_its_lbvh_natively(cuda):
    """The card machine's host builds the LBVH natively (nvcc needs a host
    g++ too), the same arrays as the NumPy build."""
    import os

    from ray_tracing_extended_tpu_torch.accel.bvh import LBVH_BUILDS

    LBVH_BUILDS.reset()
    built = presets.mesh_scene(target_tris=4000, device=cuda)[0].tri_bvh
    os.environ["RTE_NATIVE"] = "0"
    try:
        plain = presets.mesh_scene(target_tris=4000, device=cuda)[0].tri_bvh
    finally:
        del os.environ["RTE_NATIVE"]
    assert LBVH_BUILDS.routes == ["native", "numpy"]
    for f in ("bounds_min", "bounds_max", "left", "right", "leaf_row",
              "leaf_prims"):
        assert torch.equal(getattr(built, f), getattr(plain, f)), f


def test_fbx_mesh_scene_on_the_card(cuda, tmp_path):
    """A JSON scene whose mesh is a binary FBX: the BVH instantiations,
    bit for bit the image of the same arrays built by ``add_mesh``."""
    import json

    from ray_tracing_extended_tpu_torch.models.scene import Material, SceneBuilder
    from ray_tracing_extended_tpu_torch.scene.fbx import load_fbx
    from ray_tracing_extended_tpu_torch.scene.procedural import trefoil_knot_mesh
    from scene_writers import write_mesh_fbx

    v, f = trefoil_knot_mesh(target_tris=5000)
    write_mesh_fbx(tmp_path / "knot.fbx", [dict(vertices=v, polygons=f,
                                                rotation=(0, 0, 20))])
    (tmp_path / "s.json").write_text(json.dumps({
        "camera": {"position": [0, 0.3, -3], "lookAt": [0, 0, 0]},
        "environment": {"enabled": True, "skyColourZenith": [0.5, 0.7, 1.0],
                        "skyColourHorizon": [1, 1, 1]},
        "meshes": [{"fbx": "knot.fbx", "material": {"colour": [0.8, 0.5, 0.2],
                                                     "smoothness": 0.7}}]}))
    scene, cam, cfg = rtt.load_json_scene(
        tmp_path / "s.json", overrides=dict(width=128, height=72, spp=2),
        device=cuda)
    lv, lf, ln = load_fbx(tmp_path / "knot.fbx")
    b = SceneBuilder(env=scene.env.to("cpu"))
    # placed as the JSON loader places a mesh: an identity transform
    b.add_mesh(lv, lf, Material(colour=(0.8, 0.5, 0.2), smoothness=0.7),
               normals=ln, transform=np.eye(4))
    ref = b.build(build_bvh="tri", device=cuda)
    for adaptive in (False, True):
        c = dataclasses.replace(cfg, adaptive_spp=adaptive)
        mk.KERNEL.reset_counts()
        img = rtt.render_frame(scene, cam, c, 3)
        assert dict(mk.KERNEL.variant_launches) == {
            mk.variant("bvh", adaptive): mk.launches_per_call(c)}
        assert torch.isfinite(img).all() and float(img.mean()) > 0.01
        assert torch.equal(img, rtt.render_frame(ref, cam, c, 3))


def test_unity_scene_and_its_mirror_on_the_card(cuda, tmp_path):
    """``render --scene x.unity`` on the card (the chunk instantiation), and
    its exported JSON mirror through the same command, bit for bit."""
    pytest.importorskip("yaml")
    from ray_tracing_extended_tpu_torch.cli import main
    from ray_tracing_extended_tpu_torch.scene.export import export_unity_scene
    from scene_writers import demo_unity_scene

    src = tmp_path / "demo.unity"
    demo_unity_scene(src)
    export_unity_scene(src, tmp_path / "demo.json")
    images = []
    for name in ("demo.unity", "demo.json"):
        out = tmp_path / f"{name}.npy"
        mk.KERNEL.reset_counts()
        assert main(["render", "--scene", str(tmp_path / name), "--width",
                     "192", "--height", "108", "--frames", "4", "--batch",
                     "2", "--out", str(out)]) == 0
        assert dict(mk.KERNEL.variant_launches) == {mk.VARIANT_TRIANGLES: 2}
        images.append(np.load(out))
    assert np.isfinite(images[0]).all() and images[0].mean() > 0.01
    assert np.array_equal(images[0], images[1])


def test_compare_on_the_card(cuda, capsys):
    """``compare`` of the mesh: the BVH instantiation against the chunk
    scan, named in the line; exits 0."""
    from ray_tracing_extended_tpu_torch.cli import main

    mk.KERNEL.reset_counts()
    assert main(["compare", "--scene", "preset:mesh", "--width", "192",
                 "--height", "108", "--a", "mega", "--b", "bruteforce"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "AGREE"
    assert out[0].endswith(f"paths {mk.VARIANT_BVH} / {mk.VARIANT_TRIANGLES}")
    assert dict(mk.KERNEL.variant_launches) == {mk.VARIANT_BVH: 1,
                                                mk.VARIANT_TRIANGLES: 1}


def test_debug_mode_on_the_card(cuda):
    """A NaN in the accumulator raises and names the frames and the pixel;
    a clean K-frame launch passes with the same result, synchronised."""
    from ray_tracing_extended_tpu_torch.utils.profiling import debug_mode

    scene, cam, cfg = _on(cuda, *presets.rtiow_final_scene(
        width=96, height=54, spp=2))
    acc = torch.rand((54, 96, 3), device=cuda)
    ref = rtt.render_frames_and_accumulate(scene, cam, cfg, acc, 1, 4)[0]
    with debug_mode(disable_jit=True):
        out = rtt.render_frames_and_accumulate(scene, cam, cfg, acc, 1, 4)[0]
        assert torch.equal(out, ref)
        acc[20, 30, 0] = float("inf")
        with pytest.raises(FloatingPointError,
                           match=r"y=20, x=30 \(channel 0\) of frames 1-4"):
            rtt.render_frames_and_accumulate(scene, cam, cfg, acc, 1, 4)


@pytest.mark.parametrize("adaptive", [False, True], ids=["exact", "refill"])
@pytest.mark.parametrize("name", ["rtiow", "cornell", "chess", "mesh"])
def test_dup_instantiations_equal_their_twins(cuda, name, adaptive):
    """Each profiling instantiation that keeps the image (dup_intersect,
    dup_fetch, no_cull) renders its production twin's image, per-pixel
    segments and total bit for bit, in a frame and in a K = 4 fold; each
    launch is counted under its own name."""
    if name == "rtiow":
        scene, cam, cfg = presets.rtiow_final_scene(width=96, height=54, spp=4)
    else:
        scene, cam, cfg = _triangle_scene(name, width=96, height=54, spp=2)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive)
    gen = torch.Generator(device=cuda).manual_seed(5)
    acc0 = 2.0 * torch.rand((54, 96, 3), generator=gen, device=cuda)
    ref = (mk.render_frames_mega(scene, cam, cfg, 3),
           mk.render_frames_mega(scene, cam, cfg, 1, 4, accum=acc0))
    mk.KERNEL.reset_counts()
    for probe in SAME_IMAGE:
        out = (mk.render_frames_mega(scene, cam, cfg, 3, probe=probe),
               mk.render_frames_mega(scene, cam, cfg, 1, 4, accum=acc0,
                                     probe=probe))
        for (img, total, seg_map, _), (r_img, r_total, r_map, _) in zip(out, ref):
            assert torch.equal(img, r_img), probe
            assert torch.equal(seg_map, r_map), probe
            assert int(total) == int(r_total), probe
    geom = mk.geometry(scene, cfg)
    assert dict(mk.KERNEL.variant_launches) == {
        mk.variant(geom, adaptive, probe=p): 2 * mk.launches_per_call(cfg)
        for p in SAME_IMAGE}


@pytest.mark.parametrize("probe", ["dup_intersect", "dup_fetch"])
def test_dup_instantiations_match_plain_with_the_knob(cuda, probe):
    """A profiling instantiation against the plain version with the same
    knob: bench.py's mb1 gate (RTIOW, exact and refill), and
    ``render_frame_mega`` with the knob returns its frame and total."""
    scene, cam, cfg = presets.rtiow_final_scene(width=96, height=54, spp=4,
                                                max_bounce=1)
    cam = cam.replace(defocus_strength=0.0)
    for adaptive in (False, True):
        vcfg = dataclasses.replace(cfg, adaptive_spp=adaptive)
        k, k_total = mk.render_frame_mega(scene, cam, vcfg, 5, **{probe: True})
        p = mk.render_frames_plain(scene, cam, vcfg, 5, probe=probe)[0]
        _, median, channel = _gates(k, p)
        assert median < 2e-3 and channel < 5e-3, (median, channel)
        assert int(k_total) == int(mk.render_frames_mega(scene, cam, vcfg, 5)[1])


def test_profiling_refuses_fast_scatter_and_stubs(cuda):
    """What the profiling knobs refuse: nothing but stub_intersect under
    the JAX package's winner fetch (the 70k mesh), whose result is
    undefined there, and under two phases, where the JAX kernel's stub
    moves the waiting lanes; fast scatter and the stubs elsewhere launch
    their instantiations, and stub_fetch under the winner fetch is the
    production frame."""
    scene, cam, cfg = presets.three_sphere_scene(width=16, height=8, spp=1)
    fast = dataclasses.replace(cfg, fast_scatter=True)
    for probe in mk.PROBE_SETTINGS:
        img = mk.render_frames_mega(scene, cam, fast, 0, probe=probe)[0]
        assert bool(torch.isfinite(img).all()), probe
    two = dataclasses.replace(fast, adaptive_spp=True, mega_phases=2)
    for probe in ("stub_intersect", "stubs"):
        with pytest.raises(NotImplementedError, match="1687-1700"):
            mk.render_frames_mega(scene, cam, two, 0, probe=probe)
    scene, cam, cfg = _triangle_scene("mesh", width=32, height=18)
    assert mk.winner_fetch(scene)
    with pytest.raises(NotImplementedError, match="637-638"):
        mk.render_frame_mega(scene, cam, cfg, 0, stub_intersect=True)
    ref = mk.render_frames_mega(scene, cam, cfg, 0, collect_stats=True)
    out = mk.render_frames_mega(scene, cam, cfg, 0, collect_stats=True,
                                probe="stub_fetch")
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_profile_mega_tool_on_the_card(cuda, capsys):
    """The tool on the card: a small Cornell box, exact and refill, with
    the three variants' lines and the split."""
    for extra in ([], ["--adaptive-spp"]):
        assert profile_mega.main(["--scene", "preset:cornell", "--width", "64",
                                  "--height", "64", "--reps", "3", *extra]) == 0
        out = capsys.readouterr().out.splitlines()
        assert torch.cuda.get_device_name(0) in out[0]
        assert [ln.split()[0] for ln in out[1:4]] == [
            "full", "dup_intersect", "dup_fetch"]
        assert out[4].startswith("intersect ~ ")


# the knobs whose image is the production one
SAME_IMAGE = ("dup_intersect", "dup_fetch", "no_cull")
# each mode of the probe instantiations: exact, refill, refill under the
# lane knobs (two pixels a lane, two phases)
PROBE_MODES = {"exact": {}, "refill": dict(adaptive_spp=True),
               "knobs": dict(adaptive_spp=True, mega_pixels_per_lane=2,
                             mega_phases=2)}


def _probe_scene(name):
    """RTIOW (kSpheres), Cornell (kChunks), the mesh with 4,000 triangles
    (kBvh, within the one-hot fetch), small, without defocus."""
    if name == "rtiow":
        scene, cam, cfg = presets.rtiow_final_scene(width=96, height=64,
                                                    spp=4)
    elif name == "cornell":
        scene, cam, cfg = presets.cornell_box_scene(width=64, height=64,
                                                    spp=2)
    else:
        scene, cam, cfg = presets.mesh_scene(width=64, height=64, spp=2,
                                             target_tris=4000)
    return scene, cam.replace(defocus_strength=0.0), dataclasses.replace(
        cfg, mega_tile_size=32)


PROBE_CASES = [(n, m, f) for n in ("rtiow", "cornell", "mesh")
               for m in PROBE_MODES for f in (False, True)]


def _stub_cfg(probe, cfg):
    """stub_intersect (alone or in "stubs") raises under two phases
    (``mk.probe_instantiation``): its lane-knob case takes one."""
    if probe in ("stub_intersect", "stubs") and cfg.mega_phases == 2:
        return dataclasses.replace(cfg, mega_phases=1)
    return cfg


def _stub_gates(k, p, probe):
    """A stub's frame against the plain version's with the same stub:
    bench.py's mb1 gate (median per-pixel relative difference under 2e-3,
    channel means within 5e-3) where the frame is lit, and the per-pixel
    segments equal on at least 99% of pixels, their totals within 0.5%."""
    if float(p[0].abs().max()) == 0.0:
        # a black frame (stub_intersect's slot 0 emits nothing and no ray
        # misses): no channel mean to divide by
        assert float(k[0].abs().max()) == 0.0, probe
    else:
        _, median, channel = _gates(k[0], p[0])
        assert median < 2e-3 and channel < 5e-3, (probe, median, channel)
    k_map, p_map = k[2].cpu(), p[2].cpu()
    assert float((k_map == p_map).double().mean()) >= 0.99, probe
    assert abs(int(k_map.sum()) - int(p_map.sum())) <= 5e-3 * int(p_map.sum())


@pytest.mark.parametrize("name, mode, fast", PROBE_CASES,
                         ids=[f"{n}-{m}-{'fast' if f else 'bm'}"
                              for n, m, f in PROBE_CASES])
def test_probe_instantiations_against_plain_and_twins(cuda, name, mode,
                                                     fast):
    """Every profiling instantiation of a geometry, mode and sampler, on
    both routes: dup_intersect, dup_fetch and no_cull bit for bit their
    production twin (image, per-pixel segments, histogram); the stubs held
    to the plain version with the same stub (``_stub_gates``), and
    stub_intersect also on the scene's emissive copy
    (``mk.emissive_copy``), whose frame is lit; the global route bit for
    bit the staged one; each launch counted under its own name. Under the
    lane knobs stub_intersect takes one phase."""
    scene, cam, cfg = _probe_scene(name)
    cfg = dataclasses.replace(cfg, fast_scatter=fast, **PROBE_MODES[mode])
    geom = mk.geometry(scene, cfg)
    ref = mk.render_frames_mega(scene, cam, cfg, 3, collect_stats=True)
    mk.KERNEL.reset_counts()
    for probe in mk.PROBE_SETTINGS:
        pcfg = _stub_cfg(probe, cfg)
        out = {t: mk.render_frames_mega(scene, cam, pcfg, 3,
                                        collect_stats=True, probe=probe,
                                        tables=t)
               for t in mk.TABLES}
        for a, b in zip(out["global"], out["staged"]):
            assert torch.equal(a, b), probe
        if probe in SAME_IMAGE:
            for a, b in zip(out["staged"], ref):
                assert torch.equal(a, b), probe
            continue
        p = mk.render_frames_plain(scene, cam, pcfg, 3, probe=probe)
        _stub_gates(out["staged"], p, probe)
    lit = mk.emissive_copy(scene)
    pcfg = _stub_cfg("stub_intersect", cfg)
    k = mk.render_frames_mega(lit, cam, pcfg, 3, probe="stub_intersect")
    p = mk.render_frames_plain(lit, cam, pcfg, 3, probe="stub_intersect")
    assert float(p[0].mean()) > 0.0
    _stub_gates(k, p, "stub_intersect")
    # a call's kernel launches: refill's two phases (under the knobs phase
    # 2 over the lane list counts under the kKnobs name), beside them under
    # the knobs a lane pass; "stubs" launches stub_intersect's
    # instantiation, and so does the emissive copy's call
    knobs = mode == "knobs"
    per_call = 2 if cfg.adaptive_spp else 1
    want = {mk.variant(geom, cfg.adaptive_spp, fast, p, t, knobs):
            per_call * (2 if p == "stub_intersect" else 1)
            for p in mk.PROBES for t in mk.TABLES}
    want[mk.variant(geom, cfg.adaptive_spp, fast, "stub_intersect",
                    "staged", knobs)] += per_call
    if knobs:
        want[mk.LANE_PASS] = len(mk.PROBE_SETTINGS) * len(mk.TABLES) + 1
    assert dict(mk.KERNEL.variant_launches) == want


def test_production_ptxas_unchanged_by_the_probes(cuda):
    """The probe libraries are the same source with -DRTX_PROBES: the
    production library's 48 instantiations (both routes, the lane knobs'
    and their render_listed twins) keep the ``ptxas -v`` that a build
    without the probes' code gave (``mk.PTXAS_PRODUCTION``), and each
    probe library compiles only its twelve
    instantiations of the path-trace kernels (beside the lane pass's four,
    which every build of the source holds)."""
    assert _production_ptxas(mk.KERNEL.build().log) == mk.PTXAS_PRODUCTION
    lib = mk.KERNEL.probe_libraries[("no_cull", True, "global")]
    entries = [e for e in re.findall(r"Compiling entry function '(\w+)'",
                                     lib.build().log) if "render_" in e]
    assert len(entries) == 12 and all("ProbeE5" in e for e in entries)
