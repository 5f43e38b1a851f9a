"""The port's importers and exporter on the CPU against the JAX package's:
``scene/fbx.py`` (node-tree helpers, ``load_fbx``, an ``fbx`` mesh in a
JSON scene), ``scene/unity.py`` (``unity_scene_spec``,
``load_unity_scene``, nested and FBX-sourced prefabs, ``render --scene
x.unity``) and ``scene/export.py``. The files are written by the tests
(``tests/scene_writers.py``): the reference's assets are not in the repo.
Importers are host NumPy code on both sides, so they are held exactly: the
same arrays and config, and a camera within 1e-6; a rendered frame is held
to ``tests/test_megakernel.py``'s whole-frame rule.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu.cli import main as j_main
from ray_tracing_extended_tpu.scene import fbx as jfbx
from ray_tracing_extended_tpu.scene.json_scene import load_json_scene as j_json
import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.cli import main as t_main
from ray_tracing_extended_tpu_torch.interop import scene_from_arrays
from ray_tracing_extended_tpu_torch.kernels import megakernel as tmk
from ray_tracing_extended_tpu_torch.ops.camera import Camera
from ray_tracing_extended_tpu_torch.scene import fbx as tfbx
from ray_tracing_extended_tpu_torch.scene.procedural import trefoil_knot_mesh
from ray_tracing_extended_tpu_torch.scene.unity import load_unity_scene
from scene_bvhs import assert_scene_tri_bvh, record_tri_boxes
from scene_writers import demo_unity_scene, write_mesh_fbx

QUAD = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 1]],
                np.float64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_scene(port, jax_scene, tri_boxes=None):
    """Every array of the port's scene, its sphere BVH included, equals the
    JAX package's (handed over by ``interop.scene_from_arrays``); a
    triangle BVH is the SAH tree over the boxes ``tri_boxes`` recorded,
    whose LBVH is the JAX package's tree (``tests/scene_bvhs.py``)."""
    ref = scene_from_arrays(jax_scene, device="cpu")
    for part in ("spheres", "triangles", "chunks", "materials", "env",
                 "tri_bvh", "sphere_bvh"):
        a, b = getattr(port, part), getattr(ref, part)
        assert (a is None) == (b is None), part
        if a is None:
            continue
        if part == "tri_bvh":
            assert_scene_tri_bvh(a, jax_scene.tri_bvh, tri_boxes)
            continue
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype and x.shape == y.shape, (part, f.name)
            assert torch.equal(x, y), (part, f.name)
    assert port.has_triangles == ref.has_triangles


def _assert_same_camera(tc, jc):
    for name in Camera.__dataclass_fields__:
        x = getattr(tc, name)
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(getattr(jc, name)),
                                   rtol=0, atol=1e-6)


def _tight(a, b):
    d = np.abs(a - b).max(axis=-1)
    assert (d < 1e-3).mean() > 0.995, f"frac tight {(d < 1e-3).mean()}"
    assert np.abs(a - b).mean() < 1e-3


# ---------------------------------------------------------------- FBX -----
def _model(pkg, tr=None, rot=None, sc=None, pre=None):
    """A ``Model`` node tree of ``pkg``'s ``_Node`` class (the trees of
    tests/test_scene_io.py)."""
    def p_entry(key, vals):
        return pkg._Node("P", [key, "", "", ""] + list(vals))

    p70 = pkg._Node("Properties70", [])
    for key, vals in (("PreRotation", pre), ("Lcl Rotation", rot),
                      ("Lcl Translation", tr), ("Lcl Scaling", sc)):
        if vals is not None:
            p70.children.append(p_entry(key, vals))
    m = pkg._Node("Model", [])
    m.children = [p70]
    return m


def test_fbx_model_trs_matches_jax():
    """PreRotation and Lcl Rotation compose as matrices (R_pre @ R_lcl)."""
    kw = dict(pre=(90.0, 0.0, 0.0), rot=(0.0, 90.0, 0.0), tr=(1.0, 2.0, 3.0),
              sc=(2.0, 2.0, 2.0))
    t, rot, s = tfbx._model_trs(_model(tfbx, **kw))
    jt, jrot, js = jfbx._model_trs(_model(jfbx, **kw))
    for x, y in ((t, jt), (rot, jrot), (s, js)):
        assert np.array_equal(x, y)
    want = tfbx._euler_xyz_matrix((90.0, 0.0, 0.0)) @ tfbx._euler_xyz_matrix(
        (0.0, 90.0, 0.0))
    assert np.allclose(rot, want, atol=1e-12)
    assert not np.allclose(rot, tfbx._euler_xyz_matrix((90.0, 90.0, 0.0)),
                           atol=1e-3)


@pytest.mark.parametrize("case", ["nested", "single", "unknown", "cycle",
                                  "mirror"])
def test_fbx_world_affine_matches_jax(case):
    """The TRS chain up the parent links, on tests/test_scene_io.py's
    trees: a two-level hierarchy, a single model, an unknown id, a parent
    cycle (terminates) and a mirror scale (flips normals)."""
    def models(pkg):
        return {
            1: _model(pkg, tr=(1.0, 0.0, 0.0), rot=(0.0, 0.0, 90.0),
                      sc=(2.0, 2.0, 2.0)),
            2: _model(pkg, tr=(0.0, 5.0, 0.0), rot=(90.0, 0.0, 0.0),
                      sc=(1.0, 1.0, 1.0)),
            3: _model(pkg, sc=(-1.0, 1.0, 1.0)),
        }

    mid, parent_of = {
        "nested": (2, {2: 1}), "single": (1, {}), "unknown": (None, {2: 1}),
        "cycle": (2, {2: 1, 1: 2}), "mirror": (3, {}),
    }[case]
    got = tfbx._model_world_affine(mid, models(tfbx), parent_of)
    ref = jfbx._model_world_affine(mid, models(jfbx), parent_of)
    for x, y in zip(got, ref):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    L, Ln, t = got
    if case == "nested":
        r1 = tfbx._euler_xyz_matrix((0.0, 0.0, 90.0)) * 2.0
        r2 = tfbx._euler_xyz_matrix((90.0, 0.0, 0.0))
        v = np.array([0.3, -0.7, 1.1])
        want = r1 @ (r2 @ v + np.array([0.0, 5.0, 0.0])) + np.array([1.0, 0, 0])
        np.testing.assert_allclose(L @ v + t, want, atol=1e-12)
    if case == "mirror":
        n = np.array([1.0, 0.0, 0.0]) @ np.linalg.inv(Ln)
        np.testing.assert_allclose(n, [-1.0, 0.0, 0.0], atol=1e-12)


def test_fbx_triangulate_matches_jax():
    pvi = np.array([0, 1, 2, ~3, 4, 5, ~6, 0, 2, 4, 6, ~1], np.int32)
    for x, y in zip(tfbx._triangulate(pvi), jfbx._triangulate(pvi)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _models():
    """Three models: a root with quads and no normals, a child under it
    with a mirror scale, a PreRotation and per-vertex normals, and a
    grandchild with per-polygon-vertex normals."""
    corner_n = np.random.RandomState(0).normal(size=(4 + 4, 3))
    return [
        dict(vertices=QUAD, polygons=[[0, 1, 2, 3], [0, 1, 4]],
             translation=(1, 2, 3), rotation=(10, 20, 30),
             scaling=(2, 2, 2)),
        dict(vertices=QUAD * 0.5, polygons=[[0, 1, 2], [2, 3, 0], [1, 2, 4]],
             normals=np.tile([0, 0, 1.0], (5, 1)), rotation=(0, 90, 0),
             pre_rotation=(-90, 0, 0), scaling=(-1, 1, 1), parent=0),
        dict(vertices=QUAD, polygons=[[0, 1, 2, 3], [3, 2, 1, 0]],
             normals=corner_n, translation=(0, 0, 5), parent=1),
    ]


@pytest.mark.parametrize("version,compress", [(7400, True), (7400, False),
                                              (7500, True)])
def test_load_fbx_matches_jax(tmp_path, version, compress):
    path = tmp_path / "m.fbx"
    write_mesh_fbx(path, _models(), unit_scale_factor=2.54, version=version,
                   compress=compress)
    got, ref = tfbx.load_fbx(path), jfbx.load_fbx(path)
    for x, y in zip(got, ref):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    v, f, n = got
    assert v.shape == (15, 3) and f.shape == (10, 3)
    # the unit scale: 2.54 cm a unit
    np.testing.assert_allclose(v[0], np.array([1, 2, 3]) * 0.0254, rtol=1e-6)
    # unit normals where a model has them and a face uses the vertex
    assert np.allclose(np.linalg.norm(n[5:14], axis=1), 1.0, atol=1e-6)
    assert not n[:5].any() and not n[14].any()


def _knot_fbx(path, tris):
    v, f = trefoil_knot_mesh(target_tris=tris)
    write_mesh_fbx(path, [dict(vertices=v, polygons=f, rotation=(0, 0, 15),
                               scaling=(100, 100, 100))],
                   unit_scale_factor=1.0)
    return len(f)


@pytest.mark.parametrize("tris", [600, 5000], ids=["chunks", "bvh"])
def test_json_scene_fbx_mesh_matches_jax(tmp_path, monkeypatch, tris):
    """A JSON scene whose mesh is an FBX file: the same scene on both
    packages (over 4,096 faces with a triangle BVH, as for an OBJ)."""
    boxes = record_tri_boxes(monkeypatch)
    faces = _knot_fbx(tmp_path / "knot.fbx", tris)
    spec = {
        "settings": {"maxBounceCount": 3, "numRaysPerPixel": 1,
                     "width": 40, "height": 24},
        "camera": {"position": [0, 0.5, -4], "lookAt": [0, 0, 0]},
        "environment": {"enabled": True, "sunDirection": [1, 2, 3]},
        "meshes": [{"fbx": "knot.fbx",
                    "transform": {"position": [0.2, 0, 0.5],
                                  "rotationEulerDeg": [0, 30, 0],
                                  "scale": 1.5},
                    "material": {"colour": [0.8, 0.4, 0.2]}}],
    }
    p = tmp_path / "s.json"
    p.write_text(json.dumps(spec))
    js, jc, jcfg = j_json(p)
    ts, tc, tcfg = rtt.load_json_scene(p, device="cpu")
    _assert_same_scene(ts, js, boxes)
    _assert_same_camera(tc, jc)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tmk.geometry(ts, tcfg) == ("bvh" if faces > 4096 else "chunks")


# -------------------------------------------------------------- Unity -----
def _nested_prefab_scene(tmp_path):
    """tests/test_scene_io.py's nested-prefab scene, plus a sphere on an
    FBX-sourced prefab instance (its root TRS from the FBX Model node, with
    a position override)."""
    assets = tmp_path / "Assets"
    assets.mkdir()
    guid = "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa"
    fbx_guid = "bbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbb"
    (assets / "Nested.prefab").write_text(
        """%YAML 1.1
%TAG !u! tag:unity3d.com,2011:
--- !u!1 &100000
GameObject:
  m_Name: Root
--- !u!4 &400000
Transform:
  m_GameObject: {fileID: 100000}
  m_LocalRotation: {x: 0, y: 0, z: 0, w: 1}
  m_LocalPosition: {x: 0, y: 0, z: 0}
  m_LocalScale: {x: 2, y: 2, z: 2}
  m_Father: {fileID: 0}
--- !u!1 &100001
GameObject:
  m_Name: Child
--- !u!4 &400001
Transform:
  m_GameObject: {fileID: 100001}
  m_LocalRotation: {x: 0, y: 0, z: 0, w: 1}
  m_LocalPosition: {x: 1, y: 0, z: 0}
  m_LocalScale: {x: 1, y: 1, z: 1}
  m_Father: {fileID: 400000}
"""
    )
    (assets / "Nested.prefab.meta").write_text(f"guid: {guid}\n")
    write_mesh_fbx(assets / "Knight.fbx", [dict(
        vertices=QUAD, polygons=[[0, 1, 2]], translation=(0, 1, 0),
        rotation=(0, 0, 90), scaling=(0.5, 0.5, 0.5))])
    (assets / "Knight.fbx.meta").write_text(f"guid: {fbx_guid}\n")
    scene_file = assets / "nested.unity"
    sphere = "52a9ac6d93ef8ff438ff410be33e635a"
    scene_file.write_text(
        f"""%YAML 1.1
%TAG !u! tag:unity3d.com,2011:
--- !u!1001 &100
PrefabInstance:
  m_Modification:
    m_TransformParent: {{fileID: 0}}
    m_Modifications:
    - target: {{fileID: 400000, guid: {guid}, type: 3}}
      propertyPath: m_LocalPosition.x
      value: 5
    - target: {{fileID: 400001, guid: {guid}, type: 3}}
      propertyPath: m_LocalPosition.y
      value: 2
  m_SourcePrefab: {{fileID: 100100000, guid: {guid}, type: 3}}
--- !u!1 &200 stripped
GameObject:
  m_CorrespondingSourceObject: {{fileID: 100001, guid: {guid}, type: 3}}
  m_PrefabInstance: {{fileID: 100}}
--- !u!114 &300
MonoBehaviour:
  m_GameObject: {{fileID: 200}}
  m_Script: {{fileID: 11500000, guid: {sphere}, type: 3}}
  material:
    colour: {{r: 1, g: 0, b: 0, a: 1}}
--- !u!1 &201 stripped
GameObject:
  m_CorrespondingSourceObject: {{fileID: 100000, guid: {guid}, type: 3}}
  m_PrefabInstance: {{fileID: 100}}
--- !u!114 &301
MonoBehaviour:
  m_GameObject: {{fileID: 201}}
  m_Script: {{fileID: 11500000, guid: {sphere}, type: 3}}
  material:
    colour: {{r: 0, g: 1, b: 0, a: 1}}
--- !u!1001 &101
PrefabInstance:
  m_Modification:
    m_TransformParent: {{fileID: 0}}
    m_Modifications:
    - target: {{fileID: 919132149155446097, guid: {fbx_guid}, type: 3}}
      propertyPath: m_LocalPosition.z
      value: -3
  m_SourcePrefab: {{fileID: 100100000, guid: {fbx_guid}, type: 3}}
--- !u!1 &202 stripped
GameObject:
  m_PrefabInstance: {{fileID: 101}}
--- !u!114 &302
MonoBehaviour:
  m_GameObject: {{fileID: 202}}
  m_Script: {{fileID: 11500000, guid: {sphere}, type: 3}}
  material:
    colour: {{r: 0, g: 0, b: 1, a: 1}}
"""
    )
    return scene_file


def test_unity_nested_prefab_matches_jax(tmp_path):
    pytest.importorskip("yaml")
    from ray_tracing_extended_tpu.scene.unity import load_unity_scene as j_load

    path = _nested_prefab_scene(tmp_path)
    js, jc, jcfg = j_load(path)
    ts, tc, tcfg = load_unity_scene(path, device="cpu")
    _assert_same_scene(ts, js)
    assert tc is None and jc is None
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    live = ts.spheres.radius > 0
    got = {tuple(np.round(c, 5)) for c in ts.spheres.center[live].numpy()}
    # the .prefab's root at (5, 0, 0), its child at (5,0,0) + 2 * (1,2,0);
    # the FBX-sourced root at its Model's (0, 1, 0) with z set to -3
    assert got == {(5.0, 0.0, 0.0), (7.0, 4.0, 0.0), (0.0, 1.0, -3.0)}, got
    np.testing.assert_allclose(sorted(ts.spheres.radius[live].tolist()),
                               [0.25, 1.0, 1.0])


def _load_unity_both(path):
    from ray_tracing_extended_tpu.scene.unity import load_unity_scene as j_load

    return j_load(path), load_unity_scene(path, device="cpu")


def test_unity_spec_matches_jax(tmp_path):
    pytest.importorskip("yaml")
    from ray_tracing_extended_tpu.scene.unity import unity_scene_spec as j_spec
    from ray_tracing_extended_tpu_torch.scene.unity import unity_scene_spec

    path = tmp_path / "demo.unity"
    demo_unity_scene(path)
    got, ref = unity_scene_spec(path), j_spec(path)
    assert got["cfg_kw"] == ref["cfg_kw"] == dict(max_bounce=4, spp=2)
    assert len(got["spheres"]) == len(ref["spheres"]) == 25
    for (p, r, m), (jp, jr, jm) in zip(got["spheres"], ref["spheres"]):
        assert p.dtype == jp.dtype and np.array_equal(p, jp) and r == jr
        assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    assert len(got["tri_groups"]) == len(ref["tri_groups"]) > 1
    for (p, n, m), (jp, jn, jm) in zip(got["tri_groups"], ref["tri_groups"]):
        assert np.array_equal(p, jp) and np.array_equal(n, jn)
        assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    for k, v in got["camera"].items():
        assert np.array_equal(v, ref["camera"][k]), k
    for f in dataclasses.fields(got["env"]):
        assert np.array_equal(getattr(got["env"], f.name).numpy(),
                              np.asarray(getattr(ref["env"], f.name))), f.name


def test_load_unity_scene_matches_jax(tmp_path):
    """The written scene: spheres under a rotated group, a RayTracedMesh of
    localChunks with two materials, camera, light and manager."""
    pytest.importorskip("yaml")
    path = tmp_path / "demo.unity"
    demo_unity_scene(path)
    (js, jc, jcfg), (ts, tc, tcfg) = _load_unity_both(path)
    _assert_same_scene(ts, js)
    _assert_same_camera(tc, jc)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert ts.tri_bvh is None and tmk.geometry(ts, tcfg) == "chunks"


@pytest.mark.parametrize("tris", [16384, 16385])
def test_load_unity_scene_bvh_rule_matches_jax(monkeypatch, tris):
    """Above 16,384 triangles ``load_unity_scene`` adds a triangle BVH, on
    both packages, from the same spec (one soup of ``tris`` triangles; the
    parse is stubbed: the rule reads the spec only)."""
    pytest.importorskip("yaml")  # the JAX module imports it at import
    from ray_tracing_extended_tpu.models.geometry import Environment as JEnv
    from ray_tracing_extended_tpu.models.scene import Material as JMat
    from ray_tracing_extended_tpu.scene import unity as junity
    from ray_tracing_extended_tpu_torch.models.geometry import Environment
    from ray_tracing_extended_tpu_torch.models.scene import Material
    from ray_tracing_extended_tpu_torch.scene import unity as tunity

    boxes = record_tri_boxes(monkeypatch)
    rs = np.random.RandomState(3)
    tp = rs.uniform(-1, 1, (tris, 3, 3)).astype(np.float32)
    tn = np.tile(np.float32([0, 0, 1]), (tris, 3, 1))

    def spec(env, mat):
        return lambda path: dict(env=env, cfg_kw={}, spheres=[],
                                 tri_groups=[(tp, tn, mat)], camera=None)

    monkeypatch.setattr(junity, "unity_scene_spec",
                        spec(JEnv.disabled(), JMat()))
    monkeypatch.setattr(tunity, "unity_scene_spec",
                        spec(Environment.disabled(), Material()))
    js, _, jcfg = junity.load_unity_scene("x.unity")
    ts, _, tcfg = tunity.load_unity_scene("x.unity", device="cpu")
    _assert_same_scene(ts, js, boxes)
    assert (ts.tri_bvh is not None) == (tris > 16384)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_render_unity_command_matches_jax(tmp_path):
    """``render --device cpu --scene x.unity`` against the JAX CLI."""
    pytest.importorskip("yaml")
    path = tmp_path / "demo.unity"
    demo_unity_scene(path)
    a, b = tmp_path / "j.npy", tmp_path / "t.npy"
    args = ["--scene", str(path), "--width", "40", "--height", "24",
            "--spp", "1", "--max-bounce", "3", "--frames", "2"]
    assert j_main(["render", *args, "--out", str(a)]) == 0
    assert t_main(["render", "--device", "cpu", *args, "--out", str(b)]) == 0
    ja, tb = np.load(a), np.load(b)
    assert tb.shape == (24, 40, 3) and np.isfinite(tb).all() and tb.max() > 0.01
    _tight(ja, tb)


def test_export_matches_jax(tmp_path):
    """``export_unity_scene`` of both packages writes the same JSON (its
    comment names the writer) and NPZ, and the port's ``load_json_scene``
    of the mirror builds the scene its ``load_unity_scene`` builds."""
    pytest.importorskip("yaml")
    from ray_tracing_extended_tpu.scene.export import (
        export_unity_scene as j_export,
    )
    from ray_tracing_extended_tpu_torch.scene.export import (
        export_reference_scenes,
        export_unity_scene,
        main,
    )

    src = tmp_path / "demo.unity"
    demo_unity_scene(src)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    got = export_unity_scene(src, tmp_path / "t" / "demo.json")
    ref = j_export(src, tmp_path / "j" / "demo.json")
    files = [json.loads((tmp_path / d / "demo.json").read_text())
             for d in ("t", "j")]
    assert files == [got, ref]
    assert "ray_tracing_extended_tpu_torch.scene.export" in got.pop("comment")
    assert "ray_tracing_extended_tpu.scene.export" in ref.pop("comment")
    assert got == ref
    with np.load(tmp_path / "t" / "demo.npz") as a, \
            np.load(tmp_path / "j" / "demo.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 2
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    ms, mc, mcfg = rtt.load_json_scene(tmp_path / "t" / "demo.json",
                                       device="cpu")
    us, uc, ucfg = load_unity_scene(src, device="cpu")
    for part in ("spheres", "triangles", "chunks", "materials", "env"):
        for f in dataclasses.fields(getattr(ms, part)):
            assert torch.equal(getattr(getattr(ms, part), f.name),
                               getattr(getattr(us, part), f.name)), (part, f)
    for name in Camera.__dataclass_fields__:
        assert torch.equal(getattr(mc, name), getattr(uc, name)), name
    assert (mcfg.max_bounce, mcfg.spp) == (ucfg.max_bounce, ucfg.spp)
    # the directory entry point writes the same mirror for a known name
    (tmp_path / "scenes").mkdir()
    (tmp_path / "scenes" / "Knight.unity").write_text(src.read_text())
    assert export_reference_scenes(tmp_path / "scenes", tmp_path / "out") == [
        tmp_path / "out" / "knight.json"]
    assert main([str(tmp_path / "scenes"), str(tmp_path / "out2")]) == 0
    assert json.loads((tmp_path / "out2" / "knight.json").read_text()) == \
        json.loads((tmp_path / "out" / "knight.json").read_text())


def test_unity_without_yaml_raises(tmp_path, monkeypatch):
    """Where PyYAML is absent a ``.unity`` scene raises an ImportError that
    says so, and the package itself still imports."""
    path = tmp_path / "demo.unity"
    path.write_text("%YAML 1.1\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        load_unity_scene(path, device="cpu")
