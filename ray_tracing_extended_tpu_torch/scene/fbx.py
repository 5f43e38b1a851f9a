"""Minimal binary FBX (7.x) mesh reader.

Counterpart of ``ray_tracing_extended_tpu/scene/fbx.py``, line for line,
so both packages load the same arrays from a file. NumPy, ``struct`` and
``zlib`` only; nothing here touches torch (``json_scene.py`` turns the
arrays into a scene).

Reads what the reference's mesh assets need (FBX 7.4 binary; 64-bit node
headers from 7500 on): ``Geometry`` nodes' ``Vertices``,
``PolygonVertexIndex`` (polygons fan-triangulated) and ``Normals``
(``ByPolygonVertex``, averaged down to a vertex, or ``ByVertice``), each
``Model``'s local TRS composed up its parent chain, and the file's unit
scale from ``GlobalSettings``. A reader of the documented binary node
format, not an importer of the whole FBX feature set. Unity applies the
scene transform on top (RayTracedMesh.cs:37-51).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"Kaydara FBX Binary  \x00"


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props):
        self.name = name
        self.props = props
        self.children = []

    def find(self, name):
        return [c for c in self.children if c.name == name]

    def first(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _read_props(buf, off, count):
    props = []
    for _ in range(count):
        t = buf[off:off + 1].decode()
        off += 1
        if t == "Y":
            props.append(struct.unpack_from("<h", buf, off)[0]); off += 2
        elif t == "C":
            props.append(bool(buf[off])); off += 1
        elif t == "I":
            props.append(struct.unpack_from("<i", buf, off)[0]); off += 4
        elif t == "F":
            props.append(struct.unpack_from("<f", buf, off)[0]); off += 4
        elif t == "D":
            props.append(struct.unpack_from("<d", buf, off)[0]); off += 8
        elif t == "L":
            props.append(struct.unpack_from("<q", buf, off)[0]); off += 8
        elif t in "fdlib":
            n, enc, clen = struct.unpack_from("<III", buf, off)
            off += 12
            dtype = {"f": "<f4", "d": "<f8", "l": "<i8", "i": "<i4",
                     "b": "<i1"}[t]
            if enc:
                raw = zlib.decompress(buf[off:off + clen])
                off += clen
            else:
                size = n * np.dtype(dtype).itemsize
                raw = bytes(buf[off:off + size])
                off += size
            props.append(np.frombuffer(raw, dtype=dtype).copy())
        elif t in "SR":
            n = struct.unpack_from("<I", buf, off)[0]
            off += 4
            data = bytes(buf[off:off + n])
            off += n
            props.append(data.decode("utf-8", "replace") if t == "S" else data)
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
    return props, off


def _parse(buf):
    if not buf.startswith(_MAGIC):
        raise ValueError("not a binary FBX file")
    version = struct.unpack_from("<I", buf, 23)[0]
    off = 27
    root = _Node("", [])
    while off < len(buf):
        node, new_off = _read_node_tree(buf, off, version)
        if node is None:
            break
        root.children.append(node)
        off = new_off
    return root, version


def _read_node_tree(buf, off, version):
    """Read one node and its full child subtree."""
    if version >= 7500:
        end, n_props, plen = struct.unpack_from("<QQQ", buf, off)
        hdr = 24
    else:
        end, n_props, plen = struct.unpack_from("<III", buf, off)
        hdr = 12
    name_len = buf[off + hdr]
    off2 = off + hdr + 1
    if end == 0:
        return None, off2
    name = bytes(buf[off2:off2 + name_len]).decode()
    off2 += name_len
    props, off2 = _read_props(buf, off2, n_props)
    node = _Node(name, props)
    while off2 < end:
        child, off2 = _read_node_tree(buf, off2, version)
        if child is None:
            break
        node.children.append(child)
    return node, end


def _triangulate(poly_idx: np.ndarray):
    """FBX PolygonVertexIndex -> (F, 3) triangle indices + per-tri polygon id
    (negative index = last vertex of polygon, value XOR -1)."""
    tris = []
    poly_of_tri = []
    poly = []
    poly_id = 0
    for v in poly_idx:
        if v < 0:
            poly.append(~v)
            for i in range(1, len(poly) - 1):
                tris.append((poly[0], poly[i], poly[i + 1]))
                poly_of_tri.append(poly_id)
            poly = []
            poly_id += 1
        else:
            poly.append(v)
    return np.asarray(tris, np.int64), np.asarray(poly_of_tri, np.int64)


def _model_trs(model: _Node):
    """-> (translation (3,), rotation matrix (3, 3), scale (3,)).

    FBX composes the local rotation as R = R_pre @ R_lcl (PreRotation is
    applied around the Lcl Rotation, FBX SDK transform chain); Euler
    angles do NOT add, so each is converted to a matrix first and the
    matrices are multiplied in FBX order."""
    t = np.zeros(3)
    r_pre = np.eye(3)
    r_lcl = np.eye(3)
    s = np.ones(3)
    p70 = model.first("Properties70")
    if p70 is not None:
        for p in p70.find("P"):
            key = p.props[0]
            if key == "Lcl Translation":
                t = np.asarray(p.props[4:7], np.float64)
            elif key == "PreRotation":
                r_pre = _euler_xyz_matrix(np.asarray(p.props[4:7], np.float64))
            elif key == "Lcl Rotation":
                r_lcl = _euler_xyz_matrix(np.asarray(p.props[4:7], np.float64))
            elif key == "Lcl Scaling":
                s = np.asarray(p.props[4:7], np.float64)
    return t, r_pre @ r_lcl, s


def _euler_xyz_matrix(deg):
    rx, ry, rz = np.radians(deg)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx  # FBX default rotation order XYZ (applied x first)


def _model_world_affine(mid, models, parent_of):
    """Compose a model's TRS chain leaf->root into a column-form affine
    pair ``(L, Ln, t)``: ``v_world = L @ v_local + t``; ``Ln`` is the
    same linear part with per-model scales clamped away from zero (the
    normal transform inverts it, and a degenerate authored scale should
    collapse geometry without emitting NaN normals).

    FBX nests models via OO connections, each ``Lcl`` TRS relative to
    its parent model. The five reference assets are single-model; nested
    files compose here. Cycle-guarded, so malformed parent links
    terminate."""
    L = np.eye(3)
    Ln = np.eye(3)
    t = np.zeros(3)
    seen = set()
    m = mid
    while m in models and m not in seen:
        seen.add(m)
        tm, rm, sm = _model_trs(models[m])
        lm = rm * sm  # rm @ diag(sm)
        L = lm @ L
        # clamp MAGNITUDE away from zero, keeping the sign: a mirror
        # scale (-1) must flip normals, not collapse them (max(-1,eps)
        # would zero the axis and blow up inv(Ln))
        sm = np.asarray(sm, np.float64) * np.ones(3)
        sn = np.where(np.abs(sm) < 1e-20, 1e-20, sm)
        Ln = (rm * sn) @ Ln
        t = lm @ t + np.asarray(tm, np.float64)
        m = parent_of.get(m)
    return L, Ln, t


def load_fbx(path):
    """Load a binary FBX -> (vertices (V, 3) f32, faces (F, 3) i32,
    normals (V, 3) f32 or None).

    All Geometry nodes are merged (model TRS + unit scale applied).
    Per-polygon-vertex normals are averaged down to per-vertex (the
    reference renders smooth-shaded meshes; RayTracedMesh uses Unity's
    imported normals which for these assets are smoothed as well).
    """
    with open(path, "rb") as f:
        buf = f.read()
    root, version = _parse(buf)

    objects = None
    unit_scale = 1.0
    for top in root.children:
        if top.name == "GlobalSettings":
            p70 = top.first("Properties70")
            if p70 is not None:
                for p in p70.find("P"):
                    if p.props[0] == "UnitScaleFactor":
                        unit_scale = float(p.props[4]) / 100.0  # cm -> m
        if top.name == "Objects":
            objects = top
    if objects is None:
        raise ValueError("no Objects node")

    geoms = {}
    models = {}
    for node in objects.children:
        if node.name == "Geometry":
            geoms[node.props[0]] = node
        elif node.name == "Model":
            models[node.props[0]] = node

    # geometry id -> model id and model id -> parent model id via
    # Connections. Only "OO" (object-object) links are hierarchy; "OP"
    # model->model links (constraints, LookAt targets, property
    # bindings) must NOT enter the transform parent chain.
    geo_model = {}
    parent_of = {}
    for top in root.children:
        if top.name == "Connections":
            for c in top.find("C"):
                if len(c.props) < 3 or c.props[0] != "OO":
                    continue
                if c.props[1] in geoms and c.props[2] in models:
                    geo_model[c.props[1]] = c.props[2]
                elif c.props[1] in models and c.props[2] in models:
                    parent_of[c.props[1]] = c.props[2]

    all_v, all_f, all_n = [], [], []
    v_off = 0
    for gid, g in geoms.items():
        vert_node = g.first("Vertices")
        idx_node = g.first("PolygonVertexIndex")
        if vert_node is None or idx_node is None:
            continue
        verts = np.asarray(vert_node.props[0], np.float64).reshape(-1, 3)
        tris, poly_of_tri = _triangulate(np.asarray(idx_node.props[0]))

        normals = None
        layer = g.first("LayerElementNormal")
        if layer is not None and layer.first("Normals") is not None:
            nrm = np.asarray(
                layer.first("Normals").props[0], np.float64
            ).reshape(-1, 3)
            mapping = (layer.first("MappingInformationType").props[0]
                       if layer.first("MappingInformationType") else "")
            if mapping == "ByPolygonVertex" and len(nrm) >= len(
                np.asarray(idx_node.props[0])
            ):
                # average down to per-vertex
                pvi = np.asarray(idx_node.props[0])
                vids = np.where(pvi < 0, ~pvi, pvi)
                acc = np.zeros_like(verts)
                np.add.at(acc, vids, nrm[: len(vids)])
                norm = np.linalg.norm(acc, axis=1, keepdims=True)
                normals = acc / np.maximum(norm, 1e-20)
            elif mapping == "ByVertice" and len(nrm) == len(verts):
                normals = nrm

        # model transform (nested models compose up the parent chain)
        mid = geo_model.get(gid)
        lin, lin_n, t = _model_world_affine(mid, models, parent_of)
        verts = verts @ lin.T + t
        verts = verts * unit_scale
        if normals is not None:
            # Row-vector normal transform: with column-form linear part
            # L (verts map as v @ L.T), normals map by the
            # inverse-transpose, which in ROW form is n @ inv(L), not
            # n @ inv(L).T, which applies the rotation backwards (mean
            # dot(geometric, shading normal) on Suzanne: -0.39 with the
            # wrong form, +0.88 with this one).
            normals = normals @ np.linalg.inv(lin_n)
            nlen = np.linalg.norm(normals, axis=1, keepdims=True)
            normals = normals / np.maximum(nlen, 1e-20)

        all_v.append(verts)
        all_f.append(tris + v_off)
        all_n.append(
            normals if normals is not None else np.zeros_like(verts)
        )
        v_off += len(verts)

    if not all_v:
        raise ValueError("no mesh geometry in FBX")
    v = np.concatenate(all_v).astype(np.float32)
    f = np.concatenate(all_f).astype(np.int32)
    n = np.concatenate(all_n).astype(np.float32)
    if not np.abs(n).sum():
        n = None
    return v, f, n
