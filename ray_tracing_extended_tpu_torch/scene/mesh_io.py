"""Wavefront OBJ loader: vertices, triangulated faces, optional normals.

Mirrors ``ray_tracing_extended_tpu/scene/mesh_io.py``: ``v``, ``vn`` and
``f`` lines with ``v``, ``v//vn`` or ``v/vt/vn`` references, negative
indices, and fan triangulation of polygons.
"""

from __future__ import annotations

import numpy as np


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
