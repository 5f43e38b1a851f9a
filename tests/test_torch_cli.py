"""The port's ``render`` command on the CPU (``--device cpu``) against the
JAX package's: PNG and ``.npy`` output, checkpoint/resume, fused batches,
fly-throughs, and what it refuses.

Images are held to ``tests/test_megakernel.py``'s rule (over 99.5% of
pixels within 1e-3, mean abs difference under 1e-3); PNG bytes decode
(with PIL) to JAX ``save_png``'s pixels of the same image, where an ulp of
``pow`` may move a value across one 1/255 step.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ray_tracing_extended_tpu.cli import main as j_main
from ray_tracing_extended_tpu.utils.image import load_png as j_load_png
from ray_tracing_extended_tpu.utils.image import save_png as j_save_png
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.cli import main
from ray_tracing_extended_tpu_torch.models import presets as tpresets
from ray_tracing_extended_tpu_torch.utils.image import load_png, save_png

ROOT = pathlib.Path(rtt.__file__).resolve().parent.parent
SCENES = ROOT / "scenes"
SMALL = ["--width", "48", "--height", "32", "--spp", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over (each small op then waits on its
    parallel region)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(*args):
    return main(["render", "--device", "cpu", *args])


def _tight(a, b):
    d = np.abs(a - b).max(axis=-1)
    assert (d < 1e-3).mean() > 0.995, f"frac tight {(d < 1e-3).mean()}"
    assert np.abs(a - b).mean() < 1e-3


def test_png_decodes_to_jax_save_png_pixels(tmp_path):
    png, npy, metrics = tmp_path / "a.png", tmp_path / "a.npy", tmp_path / "m.jsonl"
    args = ["--scene", "preset:three_sphere", *SMALL, "--frames", "2",
            "--metrics", str(metrics)]
    assert _render(*args, "--out", str(png)) == 0
    assert _render(*args, "--out", str(npy)) == 0
    img = np.load(npy)
    j_save_png(tmp_path / "j.png", img)
    ours = np.asarray(Image.open(png).convert("RGB")).astype(int)
    theirs = np.asarray(Image.open(tmp_path / "j.png").convert("RGB")).astype(int)
    assert ours.shape == (32, 48, 3)
    assert np.abs(ours - theirs).max() <= 1 and (ours == theirs).mean() > 0.999
    # the port's reader reads both files as the JAX package's reader does
    for f in (png, tmp_path / "j.png"):
        np.testing.assert_allclose(load_png(f), j_load_png(f), rtol=0, atol=1e-6)
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert len(lines) == 4 and "alive_frac" in lines[0] and "accum_var" in lines[1]


@pytest.mark.parametrize("tone", ["none", "aces"])
def test_save_png_roundtrip(tmp_path, tone):
    img = np.random.RandomState(0).uniform(0, 1.5, (7, 9, 3)).astype(np.float32)
    save_png(tmp_path / "t.png", img, tone=tone)
    j_save_png(tmp_path / "j.png", img, tone=tone)
    a = np.asarray(Image.open(tmp_path / "t.png"))
    b = np.asarray(Image.open(tmp_path / "j.png"))
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    if tone == "none":  # top row first: row 0 of the image is the bottom
        back = load_png(tmp_path / "t.png")
        np.testing.assert_allclose(back, np.clip(img, 0, 1), atol=0.01)


def test_npy_hdr_matches_jax_cli(tmp_path):
    a, b = tmp_path / "j.npy", tmp_path / "t.npy"
    args = ["--scene", "preset:three_sphere", *SMALL, "--hdr", "--frames", "2"]
    assert j_main(["render", *args, "--out", str(a)]) == 0
    assert _render(*args, "--out", str(b)) == 0
    ta = np.load(b)
    assert ta.shape == (32, 48, 3) and ta.dtype == np.float32
    _tight(np.load(a), ta)


def test_checkpoint_resume(tmp_path):
    """--resume renders --frames more on top of the checkpoint, to the
    straight run's image bit for bit."""
    ck, out, straight = tmp_path / "ck.npz", tmp_path / "r.npy", tmp_path / "s.npy"
    args = ["--scene", "preset:three_sphere", *SMALL, "--checkpoint", str(ck),
            "--checkpoint-every", "1"]
    assert _render(*args, "--frames", "2") == 0
    assert _render(*args, "--frames", "3", "--resume", "--out", str(out)) == 0
    with np.load(ck) as z:
        assert int(z["frame"]) == 5
    assert _render("--scene", "preset:three_sphere", *SMALL, "--frames", "5",
                   "--out", str(straight)) == 0
    np.testing.assert_array_equal(np.load(out), np.load(straight))


def test_batch_equals_per_frame_and_adaptive_runs(tmp_path):
    a, b, c = tmp_path / "a.npy", tmp_path / "b.npy", tmp_path / "c.npy"
    args = ["--scene", "preset:three_sphere", "--width", "48", "--height", "24",
            "--spp", "2", "--frames", "4"]
    assert _render(*args, "--out", str(a)) == 0
    assert _render(*args, "--batch", "3", "--out", str(b)) == 0
    np.testing.assert_array_equal(np.load(a), np.load(b))
    metrics = tmp_path / "m.jsonl"
    assert _render(*args, "--batch", "2", "--adaptive-spp", "--fast-scatter",
                   "--metrics", str(metrics), "--out", str(c)) == 0
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [x["batched_frames"] for x in lines] == [2, 2]
    assert all(x["rays_per_path"] > 1.0 for x in lines)
    img = np.load(c)
    assert np.isfinite(img).all() and abs(img.mean() - np.load(a).mean()) < 0.02


def test_flythrough_matches_jax_cli(tmp_path):
    a, b = tmp_path / "j.npy", tmp_path / "t.npy"
    args = ["--scene", "preset:rtiow", "--width", "32", "--height", "24",
            "--spp", "1", "--max-bounce", "0", "--flythrough", "2",
            "--reset-on-move"]
    assert j_main(["render", *args, "--out", str(a)]) == 0
    assert _render(*args, "--out", str(b)) == 0
    ja, tb = np.load(a), np.load(b)
    assert tb.shape == (24, 32, 3) and np.isfinite(tb).all()
    # RTIOW at one segment a path: first hits only; a pixel's result can
    # flip only where a defocused camera ray grazes a silhouette
    assert (np.abs(ja - tb).max(axis=-1) < 1e-3).mean() > 0.98
    with pytest.raises(SystemExit, match="flythrough"):
        _render("--scene", "preset:three_sphere", "--reset-on-move")
    with pytest.raises(SystemExit, match="conflicts"):
        _render(*args, "--frames", "3")


def test_mesh_preset_matches_jax_cli(tmp_path):
    """``preset:mesh``, the 70k-triangle mesh through its BVH, at a small
    size: the plain BVH path against the JAX CLI's XLA BVH path."""
    a, b = tmp_path / "j.npy", tmp_path / "t.npy"
    args = ["--scene", "preset:mesh", "--width", "48", "--height", "27",
            "--spp", "1", "--max-bounce", "2"]
    assert j_main(["render", *args, "--out", str(a)]) == 0
    assert _render(*args, "--out", str(b)) == 0
    tb = np.load(b)
    assert tb.shape == (27, 48, 3) and np.isfinite(tb).all()
    _tight(np.load(a), tb)


def test_obj_scene_matches_jax_cli(tmp_path):
    """An ``.obj`` spec renders as ``mesh_scene(obj_path=...)``."""
    from ray_tracing_extended_tpu.scene.procedural import uv_sphere_mesh

    v, f = uv_sphere_mesh(16, 32)
    obj = tmp_path / "ball.obj"
    obj.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v)
                   + "".join(f"f {i + 1} {j + 1} {k + 1}\n" for i, j, k in f))
    a, b = tmp_path / "j.npy", tmp_path / "t.npy"
    args = ["--scene", str(obj), "--width", "40", "--height", "24",
            "--spp", "1", "--max-bounce", "2", "--frames", "2"]
    assert j_main(["render", *args, "--out", str(a)]) == 0
    assert _render(*args, "--out", str(b)) == 0
    _tight(np.load(a), np.load(b))


def test_unported_specs_raise(tmp_path):
    """Every scene spec of the JAX CLI is ported: a ``.unity`` spec reaches
    the Unity importer (tests/test_torch_importers.py renders one), so a
    missing file raises, as in the JAX CLI; an unknown preset exits
    (``preset:mesh`` and ``.obj`` render: the tests above; ``--mesh``
    renders: the tests below)."""
    missing = str(tmp_path / "Chess.unity")
    with pytest.raises(FileNotFoundError, match="Chess.unity"):
        _render("--scene", missing)
    with pytest.raises(SystemExit):
        _render("--scene", "preset:nope")


def test_mesh_render_matches_jax_cli(tmp_path):
    """``render --device cpu --mesh 1x2`` (both bands on the CPU) against
    the JAX CLI's ``--mesh 1x2`` on its virtual CPU devices, and bit for
    bit against the port's own render without a mesh; the metrics lines
    carry the mesh."""
    a, b, c = tmp_path / "j.npy", tmp_path / "t.npy", tmp_path / "one.npy"
    metrics = tmp_path / "m.jsonl"
    args = ["--scene", "preset:three_sphere", *SMALL, "--frames", "3"]
    assert j_main(["render", *args, "--mesh", "1x2", "--out", str(a)]) == 0
    assert _render(*args, "--mesh", "1x2", "--out", str(b),
                   "--metrics", str(metrics)) == 0
    assert _render(*args, "--out", str(c)) == 0
    _tight(np.load(a), np.load(b))
    np.testing.assert_array_equal(np.load(b), np.load(c))
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [x["frame"] for x in lines] == [0, 1, 2]
    assert all(x["mesh"] == {"spp": 1, "tiles": 2} for x in lines)


def test_mesh_needs_its_cards(monkeypatch):
    """On the card ``--mesh`` takes the first SPP x TILES visible cards and
    exits naming how many are visible where there are fewer (a card is
    never repeated); a malformed spec exits too."""
    from ray_tracing_extended_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 4 CUDA devices, 1 visible"):
        cli._parse_mesh("1x4", "cuda")
    for spec in ("1by4", "0x2", "2"):
        with pytest.raises(SystemExit, match="--mesh"):
            cli._parse_mesh(spec, "cpu")
    mesh = cli._parse_mesh("2x3", "cpu")
    assert mesh.shape == {"spp": 2, "tiles": 3}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_entry_points_refuse_a_missing_card(tmp_path):
    """Without device="cpu" the builders, loaders, presets and cameras ask
    for the card, and where there is none they raise (no quiet CPU
    fallback); the CLI exits non-zero naming CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: rtt.SceneBuilder().build(),
                 lambda: rtt.look_at((0, 0, -1), (0, 0, 0)),
                 lambda: rtt.load_json_scene(SCENES / "chess.json"),
                 lambda: tpresets.cornell_box_scene(),
                 lambda: tpresets.flythrough_cameras(2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    out = subprocess.run(
        [sys.executable, "-m", "ray_tracing_extended_tpu_torch.cli", "render",
         "--scene", "preset:three_sphere", "--width", "16", "--height", "8"],
        capture_output=True, text=True, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode != 0 and "CUDA" in out.stderr, out.stderr
