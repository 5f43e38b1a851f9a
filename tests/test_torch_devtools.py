"""The port's developer tools on the CPU: the ``compare`` command against
the JAX CLI's, ``utils.profiling.debug_mode`` (a planted NaN raises and
names its frame and pixel; a clean render passes unchanged), and
``tools/adaptive_bias.py`` (the JAX tool's output keys; refill starts
from the exact render's samples).
"""

import ast
import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu.cli import main as j_main
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.cli import main as t_main
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.models.scene import Material, SceneBuilder
from ray_tracing_extended_tpu_torch.ops.camera import look_at
from ray_tracing_extended_tpu_torch.parallel.sharding import make_mesh
from ray_tracing_extended_tpu_torch.scene.procedural import trefoil_knot_mesh
from ray_tracing_extended_tpu_torch.tools import adaptive_bias
from ray_tracing_extended_tpu_torch.utils.config import RenderConfig
from ray_tracing_extended_tpu_torch.utils.profiling import DEBUG, debug_mode

ROOT = pathlib.Path(rtt.__file__).resolve().parent.parent
STATS = re.compile(
    r"median_rel=(\S+) mean\|d\|=(\S+) max\|d\|=(\S+) frac\(rel<3e-3\)=(\S+) "
    r"means (\S+)/(\S+) \(rel (\S+)\)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- compare ----
def _knot_obj(path, tris=600):
    v, f = trefoil_knot_mesh(target_tris=tris)
    path.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v)
                    + "".join(f"f {i + 1} {j + 1} {k + 1}\n" for i, j, k in f))


def _compare(main, capsys, *args):
    rc = main(["compare", *args])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, out


def test_compare_matches_jax_cli(tmp_path, capsys):
    """``compare --device cpu`` of ``bruteforce`` against ``bvh`` on a small
    mesh scene: the JAX command's verdict and exit code, its printed
    statistics within 1e-3, and the path each side took (the mesh has a
    triangle BVH: ``bruteforce`` scans its chunk, ``bvh`` traverses)."""
    obj = tmp_path / "knot.obj"
    _knot_obj(obj)
    args = ["--scene", str(obj), "--width", "64", "--height", "48",
            "--spp", "1", "--max-bounce", "1", "--a", "bruteforce",
            "--b", "bvh", "--frame", "3"]
    j_rc, j_out = _compare(j_main, capsys, *args)
    t_rc, t_out = _compare(t_main, capsys, "--device", "cpu", *args)
    assert t_rc == j_rc == 0 and t_out[-1] == j_out[-1] == "AGREE"
    got = [float(x) for x in STATS.search(t_out[0]).groups()]
    ref = [float(x) for x in STATS.search(j_out[0]).groups()]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert got[1] > 0  # the two paths differ in a few knife-edge pixels
    assert t_out[0].startswith("bruteforce vs bvh: ")
    assert t_out[0].endswith("paths plain closest_hit_clustered<chunks> / "
                             "plain closest_hit_clustered<bvh>")


def test_compare_names_a_trivial_pair(tmp_path, capsys):
    """On a sphere scene ``mega`` and ``bvh`` take one path; the line says
    so. A disagreement exits 1."""
    args = ["--scene", "preset:three_sphere", "--width", "24", "--height",
            "16", "--spp", "1", "--device", "cpu"]
    rc, out = _compare(t_main, capsys, *args, "--a", "mega", "--b", "bvh")
    assert rc == 0 and out[-1] == "AGREE"
    assert out[0].endswith("(one path: a trivial comparison)")
    scene, cam, cfg = tpresets.three_sphere_scene(width=24, height=16, spp=1,
                                                   device="cpu")
    assert tmk.path_name(scene, cfg) == "plain closest_hit_clustered<spheres>"


# ------------------------------------------------------------ debug_mode ---
def _small(**kw):
    return tpresets.three_sphere_scene(width=32, height=16, spp=1,
                                       device="cpu", **kw)


def test_debug_mode_names_the_frame_of_a_nan_accumulator():
    scene, cam, cfg = _small()
    gen = torch.Generator().manual_seed(0)
    acc = torch.rand((16, 32, 3), generator=gen)
    acc[5, 7, 1] = float("nan")
    out, _ = rtt.render_frames_and_accumulate(scene, cam, cfg, acc, 4, 2)
    assert torch.isnan(out).sum() == 1  # outside the context: no check
    with debug_mode():
        assert DEBUG.nans and not DEBUG.sync
        with pytest.raises(FloatingPointError,
                           match=r"accumulator \(nan\) at pixel y=5, x=7 "
                                 r"\(channel 1\) of frames 4-5"):
            rtt.render_frames_and_accumulate(scene, cam, cfg, acc, 4, 2)
        with pytest.raises(FloatingPointError, match="of frame 9;"):
            rtt.render_and_accumulate(scene, cam, cfg, acc, 9)
    assert not DEBUG.nans


def test_debug_mode_passes_a_clean_render():
    scene, cam, cfg = _small()
    ref = rtt.render_progressive(scene, cam, cfg, frames=3, batch=2)
    one = rtt.render_frame(scene, cam, cfg, 5)
    with debug_mode(nans=True, disable_jit=True):
        assert DEBUG.sync
        assert torch.equal(rtt.render_progressive(scene, cam, cfg, frames=3,
                                                  batch=2), ref)
        assert torch.equal(rtt.render_frame(scene, cam, cfg, 5), one)
        rtt.render_progressive(scene, cam, cfg, frames=2,
                               mesh=make_mesh(["cpu"] * 2))
    assert not DEBUG.sync


def _nan_light_scene():
    """A sphere whose emission is NaN, seen through the lower half of the
    frame."""
    b = SceneBuilder()
    b.add_sphere((0.0, -0.6, 3.0), 0.5,
                 Material.emissive((1.0, 1.0, 1.0), float("nan")))
    cam = look_at((0, 0, 0), (0, 0, 1), fov_y_deg=60, device="cpu")
    return b.build(device="cpu"), cam, RenderConfig(width=32, height=24,
                                                     max_bounce=1, spp=1)


@pytest.mark.parametrize("batch", [1, 3])
def test_debug_mode_finds_the_pixel_in_band_launches(batch):
    """Over a split into bands the first non-finite pixel is named by its
    row in the frame, as without the split."""
    scene, cam, cfg = _nan_light_scene()
    msgs = []
    for mesh in (None, make_mesh(["cpu"] * 3)):
        with debug_mode(), pytest.raises(FloatingPointError) as e:
            rtt.render_progressive(scene, cam, cfg, frames=3, batch=batch,
                                   mesh=mesh)
        msgs.append(str(e.value))
    pixel = [re.search(r"pixel y=(\d+), x=(\d+)", m).groups() for m in msgs]
    assert pixel[0] == pixel[1], msgs
    assert ("frames 0-2" if batch == 3 else "of frame 0;") in msgs[1]


# --------------------------------------------------------- adaptive_bias ---
def _jax_tool_keys() -> dict:
    """The keys of each ``emit(step=...)`` line of the repo's
    ``tools/adaptive_bias.py``, read from its source (its refill path is
    the TPU kernel's)."""
    tree = ast.parse((ROOT / "tools" / "adaptive_bias.py").read_text())
    keys = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "emit"):
            kw = {k.arg: k.value for k in node.keywords}
            step = kw["step"]
            name = step.value if isinstance(step, ast.Constant) else "scene"
            keys[name] = set(kw)
    return keys


def test_adaptive_bias_tool_has_the_jax_tools_lines(capsys):
    assert adaptive_bias.main(["--device", "cpu", "--width", "32", "--height",
                               "24", "--frames", "2", "--spp", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    keys = _jax_tool_keys()
    assert [x["step"] for x in lines] == ["init", "rtiow", "cornell", "done"]
    assert set(lines[0]) == keys["init"] and lines[0]["device"] == "cpu"
    assert set(lines[-1]) == keys["done"]
    for line in lines[1:3]:
        assert set(line) == keys["scene"]
        assert line["frames"] == 2 and line["mean_exact"] > 0
        assert all(np.isfinite(v) for k, v in line.items() if k != "step")


@pytest.mark.parametrize("name", ["rtiow", "cornell"])
def test_refill_starts_with_the_exact_samples(name):
    """The pairing the tool relies on: a pixel's first ``spp`` samples are
    the exact render's draw for draw. With one-pixel refill groups nothing
    is refilled, and the refill image is the exact one bit for bit."""
    make = {"rtiow": tpresets.rtiow_final_scene,
            "cornell": tpresets.cornell_box_scene}[name]
    scene, cam, cfg = make(width=32, height=24, max_bounce=4, spp=2,
                           device="cpu")
    exact = tmk.render_frames_plain(scene, cam, cfg, 3)[0]
    ad = tmk.render_frames_plain(
        scene, cam, dataclasses.replace(cfg, adaptive_spp=True), 3,
        groups=np.arange(32 * 24).reshape(-1, 1))[0]
    assert torch.equal(ad, exact)
