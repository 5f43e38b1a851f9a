"""Writers of the scene files the importers read, for tests and
``chip_smoke.py``: binary FBX 7.x (``write_fbx``, ``write_mesh_fbx``) and
Unity ``.unity`` YAML (``write_unity_scene``, ``demo_unity_scene``).

No feature of either package: the reference's assets are not in the repo,
so the tests write files with known contents and hold both packages'
importers to each other on them. NumPy, ``struct`` and ``zlib`` only.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

GUID_SPHERE = "52a9ac6d93ef8ff438ff410be33e635a"
GUID_MESH = "da1318d85859d584682b30dbc26ca9f6"
GUID_MANAGER = "68c390cdf7a860745bbbdeccd7d206a9"

# ------------------------------------------------------------------ FBX ----
_FBX_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"


def _prop(v, compress: bool) -> bytes:
    """One property record: a type code and its data. Python ints are
    'L' (int64), floats 'D', str 'S', bytes 'R'; NumPy arrays of float64
    'd', float32 'f', int32 'i', int64 'l', zlib-compressed if
    ``compress``."""
    if isinstance(v, bool):
        return b"C" + bytes([v])
    if isinstance(v, int):
        return b"L" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"D" + struct.pack("<d", v)
    if isinstance(v, str):
        data = v.encode()
        return b"S" + struct.pack("<I", len(data)) + data
    if isinstance(v, bytes):
        return b"R" + struct.pack("<I", len(v)) + v
    arr = np.ascontiguousarray(v)
    code = {"float64": b"d", "float32": b"f", "int32": b"i",
            "int64": b"l"}[str(arr.dtype)]
    raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    data = zlib.compress(raw) if compress else raw
    return code + struct.pack("<III", arr.size, int(compress), len(data)) + data


def _node(node, offset: int, version: int, compress: bool) -> bytes:
    """A node ``(name, props, children)`` written at file ``offset``."""
    name, props, children = node
    wide = version >= 7500
    hdr = 25 if wide else 13  # the header, name length byte included
    pdata = b"".join(_prop(p, compress) for p in props)
    body_off = offset + hdr + len(name) + len(pdata)
    kids = b""
    for child in children:
        kids += _node(child, body_off + len(kids), version, compress)
    if children:
        kids += b"\x00" * hdr  # the null record closing the child list
    end = body_off + len(kids)
    fmt = "<QQQ" if wide else "<III"
    return (struct.pack(fmt, end, len(props), len(pdata))
            + bytes([len(name)]) + name.encode() + pdata + kids)


def write_fbx(path, nodes, version: int = 7400, compress: bool = True) -> None:
    """Write top-level ``nodes`` (each ``(name, props, children)``) as a
    binary FBX of ``version`` (64-bit headers from 7500 on)."""
    out = _FBX_MAGIC + struct.pack("<I", version)
    for node in nodes:
        out += _node(node, len(out), version, compress)
    out += b"\x00" * (25 if version >= 7500 else 13)
    Path(path).write_bytes(out)


def _p70(key, *values):
    return ("P", [key, key, "", "A", *[float(v) for v in values]], [])


def write_mesh_fbx(path, models, unit_scale_factor: float = 100.0,
                   version: int = 7400, compress: bool = True) -> None:
    """A mesh file: ``models`` is a list of dicts with ``vertices`` (V, 3),
    ``polygons`` (lists of vertex indices: triangles, quads, ...),
    optional ``normals`` ((V, 3) ``ByVertice``, or one a polygon corner
    ``ByPolygonVertex``), ``translation``, ``rotation`` and
    ``pre_rotation`` (Euler degrees, XYZ), ``scaling``, and ``parent``
    (the index of an earlier model, or None). ``unit_scale_factor`` is
    the file's centimetres a unit (100: metres)."""
    objects, links = [], []
    for i, m in enumerate(models):
        gid, mid = 1000 + 2 * i, 1001 + 2 * i
        pvi = []
        for poly in m["polygons"]:
            pvi += [int(v) for v in poly[:-1]] + [~int(poly[-1])]
        children = [
            ("Vertices", [np.asarray(m["vertices"], np.float64).reshape(-1)],
             []),
            ("PolygonVertexIndex", [np.asarray(pvi, np.int32)], []),
        ]
        if m.get("normals") is not None:
            nrm = np.asarray(m["normals"], np.float64)
            mapping = ("ByVertice" if len(nrm) == len(m["vertices"])
                       else "ByPolygonVertex")
            children.append(("LayerElementNormal", [0], [
                ("Version", [101], []),
                ("MappingInformationType", [mapping], []),
                ("ReferenceInformationType", ["Direct"], []),
                ("Normals", [nrm.reshape(-1)], []),
            ]))
        objects.append(("Geometry", [gid, f"Geometry::g{i}\x00\x01Geometry",
                                     "Mesh"], children))
        p70 = []
        for key, field in (("Lcl Translation", "translation"),
                           ("PreRotation", "pre_rotation"),
                           ("Lcl Rotation", "rotation"),
                           ("Lcl Scaling", "scaling")):
            if m.get(field) is not None:
                p70.append(_p70(key, *m[field]))
        objects.append(("Model", [mid, f"Model::m{i}\x00\x01Model", "Mesh"],
                        [("Properties70", [], p70)]))
        links.append(("C", ["OO", gid, mid], []))
        parent = m.get("parent")
        links.append(("C", ["OO", mid, 0 if parent is None
                            else 1001 + 2 * parent], []))
    write_fbx(path, [
        ("FBXHeaderExtension", [], [("FBXVersion", [version], [])]),
        ("GlobalSettings", [], [("Properties70", [], [
            ("P", ["UpAxis", "int", "Integer", "", 1], []),
            ("P", ["UnitScaleFactor", "double", "Number", "",
                   float(unit_scale_factor)], []),
        ])]),
        ("Objects", [], objects),
        ("Connections", [], links),
    ], version=version, compress=compress)


# ---------------------------------------------------------------- Unity ----
def _num(x) -> str:
    """``x`` rounded to float32, in the shortest form that reads back as
    that float32 (as Unity writes them), as a YAML 1.1 float (PyYAML's
    needs a '.' and a signed exponent)."""
    s = str(np.float32(x))
    if "e" in s:
        m, e = s.split("e")
        if "." not in m:
            m += ".0"
        if e[0] not in "+-":
            e = "+" + e
        s = f"{m}e{e}"
    elif "." not in s and s.lstrip("-").isdigit():
        s += ".0"
    return s


def _xyz(v) -> str:
    x, y, z = (_num(c) for c in v)
    return f"{{x: {x}, y: {y}, z: {z}}}"


def _quat(q) -> str:
    x, y, z, w = (_num(c) for c in q)
    return f"{{x: {x}, y: {y}, z: {z}, w: {w}}}"


def _rgb(c) -> str:
    r, g, b = (_num(v) for v in c[:3])
    return f"{{r: {r}, g: {g}, b: {b}, a: 1}}"


def _material(m: dict, indent: str) -> str:
    """A RayTracingMaterial: keys of ``m`` are the serialized field names
    (``colour``, ``emissionColour``, ``specularColour``,
    ``emissionStrength``, ``smoothness``, ``specularProbability``,
    ``flag``); what is missing takes the reader's default."""
    lines = []
    for key, value in m.items():
        if isinstance(value, (tuple, list)):
            lines.append(f"{key}: {_rgb(value)}")
        elif key == "flag":
            lines.append(f"flag: {int(value)}")
        else:
            lines.append(f"{key}: {_num(value)}")
    return "".join(f"{indent}{ln}\n" for ln in lines)


class _UnityDoc:
    """Builds a scene's YAML documents with fresh fileIDs."""

    def __init__(self):
        self.parts = ["%YAML 1.1\n%TAG !u! tag:unity3d.com,2011:\n"]
        self.next_id = 100

    def fid(self) -> int:
        self.next_id += 1
        return self.next_id

    def add(self, cls: int, fid: int, body: str) -> None:
        self.parts.append(f"--- !u!{cls} &{fid}\n{body}")

    def game_object(self, name, position=(0, 0, 0), rotation=(0, 0, 0, 1),
                    scale=(1, 1, 1), father: int = 0) -> tuple[int, int]:
        """A GameObject and its Transform -> (gameobject id, transform id)."""
        go, tf = self.fid(), self.fid()
        self.add(1, go, f"GameObject:\n  m_Name: {name}\n")
        self.add(4, tf, (
            f"Transform:\n  m_GameObject: {{fileID: {go}}}\n"
            f"  m_LocalRotation: {_quat(rotation)}\n"
            f"  m_LocalPosition: {_xyz(position)}\n"
            f"  m_LocalScale: {_xyz(scale)}\n"
            f"  m_Father: {{fileID: {father}}}\n"))
        return go, tf

    def script(self, go: int, guid: str, fields: str) -> None:
        self.add(114, self.fid(), (
            f"MonoBehaviour:\n  m_GameObject: {{fileID: {go}}}\n"
            f"  m_Script: {{fileID: 11500000, guid: {guid}, type: 3}}\n"
            + fields))


def write_unity_scene(path, spheres=(), meshes=(), camera=None, light=None,
                      manager=None, groups=()) -> None:
    """A ``.unity`` scene.

    * ``groups``: empty GameObjects to parent others under, each a dict of
      ``position``, ``rotation`` (quaternion x, y, z, w), ``scale`` and
      ``parent`` (an earlier group's index or None);
    * ``spheres``: dicts of ``position``, ``scale`` (the diameter on x),
      ``material`` (see ``_material``) and ``parent`` (a group index);
    * ``meshes``: dicts of the same transform keys, ``materials`` (a list)
      and ``chunks``: ``(tri_pos (N, 3, 3), tri_normal (N, 3, 3),
      subMeshIndex)`` in the mesh's local space;
    * ``camera``: ``position``, ``rotation``, ``fov``;
    * ``light``: the directional light's ``rotation``;
    * ``manager``: the RayTracingManager's fields: ``maxBounceCount``,
      ``numRaysPerPixel``, ``focusDistance``, ``defocusStrength``,
      ``divergeStrength`` and ``environmentSettings`` (``enabled``,
      ``groundColour``, ``skyColourHorizon``, ``skyColourZenith``,
      ``sunFocus``, ``sunIntensity``).
    """
    doc = _UnityDoc()
    group_tf = []

    def father(obj) -> int:
        return 0 if obj.get("parent") is None else group_tf[obj["parent"]]

    def placed(name, obj):
        return doc.game_object(
            name, obj.get("position", (0, 0, 0)),
            obj.get("rotation", (0, 0, 0, 1)), obj.get("scale", (1, 1, 1)),
            father(obj))

    for i, g in enumerate(groups):
        group_tf.append(placed(f"Group{i}", g)[1])
    if manager is not None:
        go, _ = doc.game_object("Manager")
        fields = "".join(f"  {k}: {_num(v)}\n" for k, v in manager.items()
                         if k != "environmentSettings")
        env = manager.get("environmentSettings")
        if env is not None:
            fields += "  environmentSettings:\n"
            for k, v in env.items():
                value = _rgb(v) if isinstance(v, (tuple, list)) else _num(v)
                fields += f"    {k}: {value}\n"
        doc.script(go, GUID_MANAGER, fields)
    for i, s in enumerate(spheres):
        go, _ = placed(f"Sphere{i}", s)
        doc.script(go, GUID_SPHERE,
                   "  material:\n" + _material(s.get("material", {}), "    "))
    for i, m in enumerate(meshes):
        go, _ = placed(f"Mesh{i}", m)
        fields = "  materials:\n"
        for mat in m.get("materials", [{}]):
            body = _material(mat, "    ") or "    flag: 0\n"
            fields += "  - " + body[4:]
        fields += "  localChunks:\n"
        for tri_pos, tri_nrm, sub in m["chunks"]:
            fields += "  - triangles:\n"
            for p, n in zip(np.asarray(tri_pos), np.asarray(tri_nrm)):
                fields += (
                    f"    - {{posA: {_xyz(p[0])}, posB: {_xyz(p[1])}, "
                    f"posC: {_xyz(p[2])}, normalA: {_xyz(n[0])}, "
                    f"normalB: {_xyz(n[1])}, normalC: {_xyz(n[2])}}}\n")
            fields += f"    subMeshIndex: {int(sub)}\n"
        doc.script(go, GUID_MESH, fields)
    if camera is not None:
        go, _ = placed("Camera", camera)
        doc.add(20, doc.fid(), (
            f"Camera:\n  m_GameObject: {{fileID: {go}}}\n  m_Enabled: 1\n"
            f"  field of view: {_num(camera.get('fov', 60.0))}\n"))
    if light is not None:
        go, _ = placed("Sun", light)
        doc.add(108, doc.fid(),
                f"Light:\n  m_GameObject: {{fileID: {go}}}\n  m_Type: 1\n")
    Path(path).write_text("".join(doc.parts))


def _axis_quat(axis, deg) -> tuple:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    h = np.radians(deg) / 2.0
    x, y, z = axis * np.sin(h)
    return (float(x), float(y), float(z), float(np.cos(h)))


def demo_unity_scene(path, seed: int = 0, n_spheres: int = 24,
                     mesh_tris: int = 256, chunk_tris: int = 64) -> None:
    """A ``.unity`` scene made from ``seed``: a ground sphere and
    ``n_spheres`` small ones of random materials (one emissive, one
    checker) under a rotated and scaled group, a ``RayTracedMesh`` of a
    trefoil knot (about ``mesh_tris`` triangles in ``localChunks`` of
    ``chunk_tris``, two materials by subMeshIndex) under the same group,
    a camera, a directional light and a RayTracingManager with the sky on.
    """
    from ray_tracing_extended_tpu_torch.scene.procedural import (
        trefoil_knot_mesh,
    )

    rs = np.random.RandomState(seed)
    v, f = trefoil_knot_mesh(target_tris=mesh_tris)
    v = np.asarray(v, np.float64)
    v = (v - v.mean(axis=0)) / np.abs(v).max()
    tri_pos = v[np.asarray(f)]
    e1 = tri_pos[:, 1] - tri_pos[:, 0]
    e2 = tri_pos[:, 2] - tri_pos[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    tri_nrm = np.repeat(fn[:, None], 3, axis=1)
    chunks = [(tri_pos[i:i + chunk_tris], tri_nrm[i:i + chunk_tris],
               (i // chunk_tris) % 2)
              for i in range(0, len(tri_pos), chunk_tris)]

    def colour():
        return [float(c) for c in rs.uniform(0.1, 0.95, 3)]

    spheres = [dict(position=(0.0, -100.0, 0.0), scale=(200.0, 200.0, 200.0),
                    material=dict(colour=(0.5, 0.55, 0.5), flag=1,
                                  specularProbability=0.0))]
    for i in range(n_spheres):
        a = 2 * np.pi * i / n_spheres
        r = 2.0 + rs.uniform(0.0, 1.5)
        d = float(rs.uniform(0.3, 0.7))
        mat = dict(colour=colour(), smoothness=float(rs.uniform()),
                   specularProbability=float(rs.uniform(0.0, 0.5)),
                   specularColour=colour())
        if i == 0:
            mat.update(emissionColour=(1.0, 0.9, 0.7), emissionStrength=4.0)
        spheres.append(dict(
            position=(r * np.cos(a), d / 2.0, r * np.sin(a)),
            scale=(d, d, d), material=mat, parent=0))
    write_unity_scene(
        path,
        groups=[dict(position=(0.1, 0.0, 0.2),
                     rotation=_axis_quat((0, 1, 0), 25.0),
                     scale=(1.1, 1.1, 1.1))],
        spheres=spheres,
        meshes=[dict(position=(0.0, 1.0, 0.0),
                     rotation=_axis_quat((1, 0.3, 0), 40.0),
                     scale=(1.2, 0.9, 1.2), parent=0,
                     materials=[dict(colour=(0.8, 0.5, 0.2), smoothness=0.7,
                                     specularProbability=0.3),
                                dict(colour=(0.2, 0.4, 0.9),
                                     specularProbability=0.0)],
                     chunks=chunks)],
        camera=dict(position=(0.0, 2.0, -6.5),
                    rotation=_axis_quat((1, 0, 0), 12.0), fov=45.0),
        light=dict(rotation=_axis_quat((1, 0.2, 0), 50.0)),
        manager=dict(maxBounceCount=4, numRaysPerPixel=2, focusDistance=6.0,
                     defocusStrength=0.0, divergeStrength=0.3,
                     environmentSettings=dict(
                         enabled=1, groundColour=(0.35, 0.3, 0.35),
                         skyColourHorizon=(1.0, 1.0, 1.0),
                         skyColourZenith=(0.08, 0.37, 0.73),
                         sunFocus=500.0, sunIntensity=10.0)),
    )
