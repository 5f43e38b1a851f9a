"""The reference against the port's plain CPU path, at a few pixels.

The port's plain version takes the kernel's direct test forms with
``plain_intersector(..., direct=True)``, the forms the reference states;
then both give the same image and segments bit for bit."""

from pathlib import Path

import numpy as np
import pytest
import torch

import reference

W, H = 32, 16


def _port(cell):
    from ray_tracing_extended_tpu_torch import load_json_scene
    from ray_tracing_extended_tpu_torch.models.presets import rtiow_final_scene

    if cell == "rtiow":
        return rtiow_final_scene(width=W, height=H, max_bounce=12, spp=2,
                                 seed=20260816, device="cpu")
    return load_json_scene(Path(__file__).parents[1] / "scenes"
                           / "chess.json",
                           overrides=dict(width=W, height=H, spp=1,
                                          max_bounce=4), device="cpu")


def _ref(cell):
    if cell == "rtiow":
        return reference.rtiow_final(20260816)
    scene, cam, _ = reference.json_scene(
        Path(__file__).parents[1] / "scenes" / "chess.json")
    return scene, cam


@pytest.mark.parametrize("cell", ["rtiow", "chess"])
def test_reference_matches_port_plain_path(cell):
    from ray_tracing_extended_tpu_torch.kernels.megakernel import (
        plain_intersector, render_frames_plain)

    scene, cam, cfg = _port(cell)
    frame = 4097
    img, segs, seg_map, _ = render_frames_plain(
        scene, cam, cfg, frame,
        intersect_fn=plain_intersector(scene, cam, cfg, direct=True))
    rs, rc = _ref(cell)
    tr = reference.Tracer(rs, rc, W, H, cfg.max_bounce, cfg.spp, "cpu")
    pix = torch.arange(W * H)
    mean, s = tr.render_lanes(pix, torch.full((W * H,), frame), 1024)
    assert torch.equal(mean, img.reshape(-1, 3))
    assert torch.equal(s, seg_map.reshape(-1).long())
    assert int(s.sum()) == int(segs)


def test_fold_matches_port_accumulate():
    from ray_tracing_extended_tpu_torch.ops.accumulate import accumulate

    rng = np.random.default_rng(3)
    means = rng.random((5, 7, 3)).astype(np.float32) * 1.5
    for clamp in (False, True):
        acc = torch.zeros((7, 3))
        for k in range(5):
            acc = accumulate(acc, torch.from_numpy(means[k]), 1000 + k,
                             clamp=clamp)
        got = reference.fold(range(1000, 1005), means,
                             np.zeros((7, 3), np.float32), clamp)
        assert np.array_equal(got, acc.numpy())


def test_rtiow_layout_matches_the_book_rule():
    from ray_tracing_extended_tpu_torch.models.presets import rtiow_final_scene

    scene, _, _ = rtiow_final_scene(width=8, height=8, seed=99, device="cpu")
    rs, _ = reference.rtiow_final(99)
    n = len(rs.sph_radius)
    assert n == int((scene.spheres.radius > 0).sum())
    assert np.array_equal(rs.sph_center, scene.spheres.center[:n].numpy())
    assert np.array_equal(rs.sph_radius, scene.spheres.radius[:n].numpy())


def test_ops_per_segment_counts_every_box_and_the_entered_primitives():
    rs, rc = _ref("chess")
    tr = reference.Tracer(rs, rc, W, H, 4, 1, "cpu")
    o = torch.tensor([[0.0, 100.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0]])  # up, away from the board: no box
    ops = tr.ops_per_segment(o, d, torch.tensor([float("inf")]))
    assert float(ops) == reference.OPS_BOX * tr.supers.shape[0]
    t, _, hit = tr.closest_hit(o, -d)
    assert bool(hit)
    down = tr.ops_per_segment(o, -d, t)
    assert float(down) > float(ops) + reference.OPS_TRIANGLE


def test_a_zero_draw_reads_the_ground_as_the_kernel_does():
    """A uniform draw of exactly 0 (once in 2^32) sends a Box-Muller
    direction to NaN; the kernel's ``fminf`` / ``fmaxf`` drop the NaN in
    the sky's smoothstep and the sun, so that path reads the ground
    colour, finite: the reference the same."""
    rs, rc = _ref("rtiow")
    tr = reference.Tracer(rs, rc, W, H, 4, 1, "cpu")
    inv_mul = pow(reference.PCG_MUL, -1, 1 << 32)
    state = torch.tensor([((0 - reference.PCG_INC) * inv_mul) & reference.MASK])
    _, zero = tr.random_value(state)
    assert float(zero) == 0.0
    d = torch.full((1, 3), float("nan"))
    env = tr.environment(d)
    assert torch.equal(env, tr.env["ground"][None, :])
