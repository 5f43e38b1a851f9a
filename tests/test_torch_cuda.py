"""The CUDA kernel on the card: against its plain PyTorch version, its
launch count and outputs, and what it refuses.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses
import pathlib

import pytest
import torch

import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.kernels import megakernel as mk
from ray_tracing_extended_tpu_torch.models import presets

pytestmark = pytest.mark.cuda

SCENES = pathlib.Path(rtt.__file__).resolve().parent.parent / "scenes"


def _triangle_scene(name, **small):
    """Cornell (the preset) or Chess (the shipped mirror) at a small size,
    on the CPU."""
    if name == "cornell":
        return presets.cornell_box_scene(**small)
    return rtt.load_json_scene(SCENES / f"{name}.json", overrides=small)


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


def test_triangle_scene_never_takes_the_plain_path(cuda, monkeypatch):
    """Through the public entry points a triangle scene on the card runs the
    triangle variant, one launch a call, and nothing of the plain path."""

    def refuse(*args, **kwargs):
        raise AssertionError("the plain path ran on a CUDA scene")

    for name in ("render_frames_plain", "_render_frame_plain", "render_block"):
        monkeypatch.setattr(mk, name, refuse)
    scene, cam, cfg = _on(cuda, *_triangle_scene(
        "chess", width=64, height=36, max_bounce=3, spp=1))
    before = dict(mk.KERNEL.variant_launches)
    img, segs, hist = rtt.render_frame_with_stats(scene, cam, cfg, 0,
                                                  bounce_stats=True)
    acc = torch.zeros((36, 64, 3), device=cuda)
    acc, segs3 = rtt.render_frames_and_accumulate(scene, cam, cfg, acc, 0, 3)
    acc = rtt.render_and_accumulate(scene, cam, cfg, acc, 3)
    torch.cuda.synchronize()
    after = mk.KERNEL.variant_launches
    assert after[mk.VARIANT_TRIANGLES] == before.get(mk.VARIANT_TRIANGLES, 0) + 3
    assert after[mk.VARIANT_SPHERES] == before.get(mk.VARIANT_SPHERES, 0)
    assert bool(torch.isfinite(img).all() and torch.isfinite(acc).all())
    hist = hist.cpu()
    assert int(hist[0]) == 64 * 36 and int(hist.sum()) == int(segs)
    assert int(segs3) >= 3 * 64 * 36


def test_plain_on_card_matches_plain_on_cpu(cuda):
    """The plain version computes its transcendentals in float64 on the CPU
    and with the card's f32 library on CUDA; the two are held to the
    tolerance the CPU tests hold the port to against the JAX package."""
    scene, cam, cfg0 = presets.rtiow_final_scene(width=48, height=27, spp=2)
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
    """Triangle scenes render on the card; adaptive_spp, fast_scatter and
    the BVH intersector still raise, on sphere and triangle scenes."""
    scene, cam, cfg = _on(cuda, *presets.three_sphere_scene(
        width=16, height=8, spp=1))
    tri_scene, tri_cam, tri_cfg = _on(cuda, *presets.cornell_box_scene(
        width=16, height=16, spp=1))
    for s, c, base in ((scene, cam, cfg), (tri_scene, tri_cam, tri_cfg)):
        for change in (dict(adaptive_spp=True), dict(fast_scatter=True),
                       dict(intersector="bvh")):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                rtt.render_frame(s, c, dataclasses.replace(base, **change), 0)
    img = rtt.render_frame(tri_scene, tri_cam, tri_cfg, 0)
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    with pytest.raises(ValueError):
        rtt.render_frames_and_accumulate(
            scene, cam, cfg, torch.zeros((8, 16, 3), device=cuda)[:, ::1, :2], 0)
    with pytest.raises(ValueError):
        rtt.render_frame(scene, cam.to("cpu"), cfg, 0)
