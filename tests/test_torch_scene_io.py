"""The port's scene entry points on the CPU against the JAX package: the
octree chunker, ``SceneBuilder.add_mesh`` and ``set_mesh_transform``, the
OBJ loader and ``load_json_scene`` on every shipped scene file. These are
host numpy code on both sides, so they are held exactly: the same arrays,
dtypes and config, and a camera within 1e-6.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu.accel.chunks import create_chunks as j_chunks
from ray_tracing_extended_tpu.models import scene as jscene
from ray_tracing_extended_tpu.scene.json_scene import (
    _transform_matrix as j_transform,
    load_json_scene as j_load,
)
from ray_tracing_extended_tpu.scene.mesh_io import load_obj as j_obj
from ray_tracing_extended_tpu.scene.procedural import (
    trefoil_knot_mesh,
    uv_sphere_mesh,
)
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.accel.chunks import create_chunks as t_chunks
from ray_tracing_extended_tpu_torch.interop import scene_from_arrays
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.models import scene as tscene
from ray_tracing_extended_tpu_torch.ops.camera import Camera
from ray_tracing_extended_tpu_torch.scene.json_scene import (
    _transform_matrix as t_transform,
)
from ray_tracing_extended_tpu_torch.scene.mesh_io import load_obj as t_obj

SCENES = sorted(
    (pathlib.Path(__file__).resolve().parent.parent / "scenes").glob("*.json")
)
TRANSFORM = {"position": [0.5, 1.0, 2.0], "rotationEulerDeg": [10, 35, -20],
             "scale": [1.0, 1.5, 0.8]}


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


def _assert_same_scene(port, jax_scene):
    """Every array of the port's scene equals the JAX package's, handed over
    with ``interop.scene_from_arrays``, in dtype, shape and value."""
    ref = scene_from_arrays(jax_scene, device="cpu")
    for part in ("spheres", "triangles", "chunks", "materials", "env"):
        a, b = getattr(port, part), getattr(ref, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype and x.shape == y.shape, (part, f.name)
            assert torch.equal(x, y), (part, f.name)
    assert port.has_triangles == ref.has_triangles


def test_scene_files_are_the_seven_shipped():
    assert len(SCENES) == 7


def _soup(mesh):
    if mesh == "trefoil":
        v, f = trefoil_knot_mesh(target_tris=3000)
    else:
        v, f = uv_sphere_mesh(n_lat=12, n_lon=24)
    nrm = np.random.RandomState(0).standard_normal(v.shape).astype(np.float32)
    return v, f, nrm


@pytest.mark.parametrize("max_tris", [48, 16])
@pytest.mark.parametrize("mesh", ["trefoil", "uv_sphere"])
def test_create_chunks_matches_jax(mesh, max_tris):
    v, f, nrm = _soup(mesh)
    a = j_chunks(v[f], nrm[f], max_tris=max_tris)
    b = t_chunks(v[f], nrm[f], max_tris=max_tris)
    assert len(b) == len(a) > 8
    for x, y in zip(a, b):
        for name in ("tri_pos", "tri_normal", "bounds_min", "bounds_max"):
            ax, by = getattr(x, name), getattr(y, name)
            assert by.dtype == ax.dtype
            np.testing.assert_array_equal(by, ax)
    assert sum(len(c.tri_pos) for c in b) == len(f)


def _builders():
    """The same calls on both packages' builders: a sphere, a chunked mesh
    with a transform, a soup, an unchunked mesh with its own normals."""
    v, f = trefoil_knot_mesh(target_tris=2000)
    sv, sf = uv_sphere_mesh(n_lat=8, n_lon=16, radius=0.5)
    snrm = sv / np.linalg.norm(sv, axis=1, keepdims=True)
    soup = np.random.RandomState(1).uniform(-1, 1, (5, 3, 3)).astype(np.float32)
    out = []
    for mod, transform in ((jscene, j_transform), (tscene, t_transform)):
        b = mod.SceneBuilder()
        b.add_sphere((0.0, -101.0, 0.0), 100.0,
                     mod.Material.lambertian((0.5, 0.5, 0.5)))
        b.add_mesh(v, f, mod.Material.metal((0.8, 0.7, 0.6), smoothness=0.9),
                   transform=transform(TRANSFORM))
        b.add_triangles(soup, np.ones_like(soup), mod.Material.emissive((1, 1, 1), 3.0))
        b.add_mesh(sv, sf, mod.Material.dielectric(1.5), normals=snrm,
                   chunked=False)
        out.append(b)
    return out


def test_add_mesh_matches_jax():
    jb, tb = _builders()
    _assert_same_scene(tb.build(device="cpu"), jb.build())


def test_set_mesh_transform_matches_jax():
    jb, tb = _builders()
    first = tb.build(device="cpu")
    for b, transform in ((jb, j_transform), (tb, t_transform)):
        b.set_mesh_transform(0, transform({"position": [0, 2, 0],
                                           "rotationEulerDeg": [0, 90, 0]}))
        b.set_mesh_transform(1, transform({"scale": 2.0}))
    moved = tb.build(device="cpu")
    _assert_same_scene(moved, jb.build())
    # the chunks move with the mesh; their count and ranges do not
    assert torch.equal(moved.chunks.num_tris, first.chunks.num_tris)
    assert not torch.equal(moved.chunks.bounds_min, first.chunks.bounds_min)
    with pytest.raises(IndexError):
        tb.set_mesh_transform(2, None)


def _write_obj(path):
    v, f = uv_sphere_mesh(n_lat=10, n_lon=20)
    lines = [f"v {x} {y} {z}" for x, y, z in v]
    lines += [f"vn {x} {y} {z}" for x, y, z in v / np.linalg.norm(v, axis=1)[:, None]]
    # a quad, a negative index and v/vt/vn references
    lines += [f"f {a + 1}//{a + 1} {b + 1}//{b + 1} {c + 1}//{c + 1}"
              for a, b, c in f[:-2]]
    lines.append(f"f {f[-2][0] + 1}/1/{f[-2][0] + 1} -1/1/-1 -2/1/-2 -3/1/-3")
    path.write_text("\n".join(lines) + "\n")


def test_load_obj_matches_jax(tmp_path):
    p = tmp_path / "ball.obj"
    _write_obj(p)
    a, b = j_obj(p), t_obj(p)
    for x, y in zip(a, b):
        assert y.dtype == x.dtype
        np.testing.assert_array_equal(y, x)


def _assert_same_camera(tc, jc):
    for name in Camera.__dataclass_fields__:
        x = getattr(tc, name)
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(getattr(jc, name)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("path", SCENES, ids=lambda p: p.stem)
def test_load_json_scene_matches_jax(path):
    js, jc, jcfg = j_load(path)
    ts, tc, tcfg = rtt.load_json_scene(path, device="cpu")
    _assert_same_scene(ts, js)
    _assert_same_camera(tc, jc)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_load_json_scene_obj_mesh_matches_jax(tmp_path):
    _write_obj(tmp_path / "ball.obj")
    spec = {
        "settings": {"maxBounceCount": 5, "numRaysPerPixel": 3,
                     "width": 64, "height": 32},
        "camera": {"position": [0, 0, -3], "lookAt": [0, 0, 0],
                   "defocusStrength": 2.0},
        "environment": {"enabled": True, "sunDirection": [1, 2, 3]},
        "spheres": [{"position": [0, 0, 0], "radius": 0.5,
                     "material": {"colour": [1, 0, 0], "flag": "dielectric"}}],
        "meshes": [{"obj": "ball.obj", "transform": TRANSFORM,
                    "material": {"colour": [0.2, 0.8, 0.2], "flag": 1}},
                   {"obj": "ball.obj", "chunked": False}],
    }
    p = tmp_path / "s.json"
    p.write_text(json.dumps(spec))
    js, jc, jcfg = j_load(p, overrides={"spp": 2})
    ts, tc, tcfg = rtt.load_json_scene(p, overrides={"spp": 2},
                                       device="cpu")
    _assert_same_scene(ts, js)
    _assert_same_camera(tc, jc)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert ts.has_triangles and ts.chunks.num_tris.shape[0] > 2


def test_kernel_tables_layout():
    """The CUDA kernel's triangle and chunk tables, built on the CPU: the
    rows the kernel reads and the chunk ranges as int32 bits."""
    scene, cam, cfg = rtt.load_json_scene(SCENES[1].parent / "knight.json",
                                          device="cpu")
    tab = tmk.scene_tables(scene, cam, cfg)
    tri, ch = scene.triangles, scene.chunks
    assert tab.tri_rows.shape == (tri.count, 12) and tab.tri_rows.is_contiguous()
    assert torch.equal(tab.tri_rows[:, 0:3], tri.pos_a)
    assert torch.equal(tab.tri_rows[:, 3:6], tri.edge_ab)
    assert torch.equal(tab.tri_rows[:, 6:9], tri.edge_ac)
    assert torch.equal(tab.tri_rows[:, 9:12], tri.n)
    assert torch.equal(tab.tri_normals[:, 3:6], tri.normal_b)
    assert tab.tri_mat.dtype == torch.int32
    # a chunk row is two float4s: (box min, first triangle), (box max, count)
    assert tab.chunks.shape == (ch.num_tris.shape[0], 8)
    assert tab.chunks.is_contiguous()
    assert torch.equal(tab.chunks[:, 0:3], ch.bounds_min)
    assert torch.equal(tab.chunks[:, 4:7], ch.bounds_max)
    bits = tab.chunks[:, [3, 7]].contiguous().view(torch.int32)
    assert torch.equal(bits[:, 0], ch.first_tri)
    assert torch.equal(bits[:, 1], ch.num_tris)
    assert torch.equal(bits[1:, 0], bits[:-1, 0] + bits[:-1, 1])
    assert 0 < int(bits[:, 1].sum()) < tri.count
    spheres_only = tmk.scene_tables(
        *rtt.load_json_scene(SCENES[0], device="cpu")[:2], cfg)
    assert spheres_only.chunks is None and spheres_only.tri_rows is None
