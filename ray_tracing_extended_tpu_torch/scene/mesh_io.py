"""Mesh file loaders: Wavefront OBJ and STL.

``load_obj`` mirrors ``ray_tracing_extended_tpu/scene/mesh_io.py``: ``v``,
``vn`` and ``f`` lines with ``v``, ``v//vn`` or ``v/vt/vn`` references,
negative indices, and fan triangulation of polygons. ``load_stl`` reads
binary and ASCII STL (a triangle soup with a normal a facet) into the same
indexed form.
"""

from __future__ import annotations

import re
import struct

import numpy as np

_STL_FACET = np.dtype([("normal", "<f4", (3,)), ("corners", "<f4", (3, 3)),
                       ("attribute", "<u2")])
_ASCII_FLOATS = r"\s+([-+0-9.eEinfINFaA]+)" * 3
_ASCII_NORMAL = re.compile(rb"facet\s+normal" + _ASCII_FLOATS.encode())
_ASCII_VERTEX = re.compile(rb"vertex" + _ASCII_FLOATS.encode())


def load_obj(path):
    """-> (vertices (V, 3) f32, faces (F, 3) int32, normals (V, 3) f32 or
    None). A vertex's normal is the normalised sum of the normals its face
    corners reference."""
    verts = []
    vnormals = []
    faces = []
    face_normal_ids = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("vn "):
                parts = line.split()
                vnormals.append(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
            elif line.startswith("f "):
                idx = []
                nidx = []
                for ref in line.split()[1:]:
                    comps = ref.split("/")
                    vi = int(comps[0])
                    idx.append(vi - 1 if vi > 0 else len(verts) + vi)
                    if len(comps) >= 3 and comps[2]:
                        ni = int(comps[2])
                        nidx.append(ni - 1 if ni > 0 else len(vnormals) + ni)
                for i in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[i], idx[i + 1]))
                    if nidx:
                        face_normal_ids.append((nidx[0], nidx[i], nidx[i + 1]))

    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int32)
    n = None
    if vnormals and len(face_normal_ids) == len(faces):
        vn = np.asarray(vnormals, np.float32)
        acc = np.zeros_like(v)
        fi = np.asarray(face_normal_ids, np.int64)
        np.add.at(acc, f.reshape(-1), vn[fi.reshape(-1)])
        norm = np.linalg.norm(acc, axis=1, keepdims=True)
        n = (acc / np.maximum(norm, 1e-20)).astype(np.float32)
    return v, f, n


def _stl_facets(data: bytes):
    """-> (facet normals (F, 3), corners (F, 3, 3)) of an STL file's bytes:
    binary where the facet count at byte 80 gives the file's length, else
    ASCII (``solid`` ... ``endsolid``)."""
    if len(data) >= 84:
        (n,) = struct.unpack_from("<I", data, 80)
        if len(data) == 84 + n * _STL_FACET.itemsize:
            facets = np.frombuffer(data, _STL_FACET, count=n, offset=84)
            return facets["normal"], facets["corners"]
    if not data.lstrip().startswith(b"solid"):
        raise ValueError(
            f"not an STL file: {len(data)} bytes, neither a binary file "
            "whose facet count gives its length nor ASCII ('solid')")
    normals = _ASCII_NORMAL.findall(data)
    corners = _ASCII_VERTEX.findall(data)
    facets = data.count(b"endfacet")
    if (not re.search(rb"endsolid", data) or len(normals) != facets
            or len(corners) != 3 * facets):
        raise ValueError(
            f"truncated or malformed ASCII STL: {len(normals)} facet "
            f"normals, {facets} facets closed, {len(corners)} vertices")
    return (np.array(normals, np.float64).astype(np.float32).reshape(-1, 3),
            np.array(corners, np.float64).astype(np.float32).reshape(-1, 3,
                                                                      3))


def load_stl(path):
    """-> (vertices (V, 3) f32, faces (F, 3) int32, normals (V, 3) f32), as
    ``load_obj`` returns them, from a binary or ASCII STL file.

    Equal corners are welded into one vertex (exactly: the same three
    floats, -0 and 0 alike), in the order of their first appearance; each
    face keeps its facet's corner order, so its winding. STL stores a
    normal a facet and none a vertex, so a vertex's normal is formed as
    ``load_obj`` forms it from the normals its face corners reference: the
    normalised sum of its facets' stored normals, a facet with a zero
    normal giving its winding's unit normal in its place. A file cut short
    raises ValueError."""
    with open(path, "rb") as f:
        facet_n, corners = _stl_facets(f.read())
    flat = np.ascontiguousarray(corners.reshape(-1, 3) + np.float32(0.0))
    keys = flat.view(np.dtype((np.void, flat.dtype.itemsize * 3))).ravel()
    _, first, inverse = np.unique(keys, return_index=True,
                                  return_inverse=True)
    # renumber the welded vertices by their first appearance
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    faces = rank[inverse.reshape(-1)].reshape(-1, 3).astype(np.int32)
    verts = flat[np.sort(first)]
    winding = np.cross(corners[:, 1] - corners[:, 0],
                       corners[:, 2] - corners[:, 0])
    winding /= np.maximum(np.linalg.norm(winding, axis=1, keepdims=True),
                          1e-30)
    stored = np.any(facet_n != 0.0, axis=1, keepdims=True)
    per_face = np.where(stored, facet_n, winding).astype(np.float32)
    acc = np.zeros_like(verts)
    np.add.at(acc, faces.reshape(-1), np.repeat(per_face, 3, axis=0))
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    return verts, faces, (acc / np.maximum(norm, 1e-20)).astype(np.float32)
