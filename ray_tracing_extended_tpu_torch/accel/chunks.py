"""Octree mesh chunker, on the host in numpy.

Mirrors ``ray_tracing_extended_tpu/accel/chunks.py`` (MeshSplitter,
Helpers/MeshSplitter.cs) and gives exactly its chunks, membership order and
bounds:

  * a mesh becomes one chunk whose AABB starts as a 0.01-sized box at the
    first vertex and grows to hold every vertex (MeshSplitter.cs:35-63);
  * a chunk of more than ``max_tris`` (48) triangles splits, up to depth 6,
    into 8 octants of half its size, centres at +/- size/4, visited x, y, z
    nested, -1 before +1 (MeshSplitter.cs:65-99);
  * a triangle goes to the first octant that holds ANY of its vertices
    (inclusive bounds, MeshSplitter.cs:101-124);
  * a child's bounds start from its octant box and only grow
    (MeshSplitter.cs:104,115-117).

The chunks' AABBs gate the triangle scan of the CUDA kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_DEPTH = 6  # MeshSplitter.cs:8
MAX_TRIS_PER_CHUNK = 48  # MeshSplitter.cs:9


@dataclasses.dataclass
class Chunk:
    """One chunk (MeshChunk.cs:5-18): its triangles and their AABB."""

    tri_pos: np.ndarray  # (n, 3, 3) f32 vertices A, B, C
    tri_normal: np.ndarray  # (n, 3, 3) f32 per-vertex normals
    bounds_min: np.ndarray  # (3,) f32
    bounds_max: np.ndarray  # (3,) f32


def _encapsulate(bmin, bmax, pts):
    return np.minimum(bmin, pts.min(axis=0)), np.maximum(bmax, pts.max(axis=0))


def create_chunks(
    tri_pos: np.ndarray,
    tri_normal: np.ndarray,
    max_tris: int = MAX_TRIS_PER_CHUNK,
    max_depth: int = MAX_DEPTH,
) -> list[Chunk]:
    """Split a triangle soup (n, 3, 3) into octree chunks of at most
    ``max_tris`` triangles (fewer levels deep than ``max_depth``)."""
    tri_pos = np.asarray(tri_pos, np.float32)
    tri_normal = np.asarray(tri_normal, np.float32)
    if tri_pos.shape[0] == 0:
        return []
    # root bounds: Bounds(verts[0], 0.01) grown over every vertex
    # (MeshSplitter.cs:39,51-53)
    v0 = tri_pos[0, 0]
    bmin, bmax = _encapsulate(v0 - 0.005, v0 + 0.005, tri_pos.reshape(-1, 3))
    out: list[Chunk] = []
    _split(tri_pos, tri_normal, bmin, bmax, 0, max_tris, max_depth, out)
    return out


def _split(pos, nrm, bmin, bmax, depth, max_tris, max_depth, out):
    n = pos.shape[0]
    if n <= max_tris or depth >= max_depth:
        out.append(Chunk(pos, nrm, bmin.copy(), bmax.copy()))
        return
    center = (bmin + bmax) * 0.5
    q = (bmax - bmin) / 4.0
    taken = np.zeros(n, dtype=bool)
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            for sz in (-1.0, 1.0):
                if taken.all():
                    return
                oc = center + q * np.array([sx, sy, sz], np.float32)
                obmin = oc - q
                obmax = oc + q
                # (n, 3): is each vertex inside the octant box
                inside = ((pos >= obmin) & (pos <= obmax)).all(axis=2)
                claim = inside.any(axis=1) & ~taken
                if not claim.any():
                    continue
                taken |= claim
                cpos = pos[claim]
                cbmin, cbmax = _encapsulate(
                    obmin.copy(), obmax.copy(), cpos.reshape(-1, 3)
                )
                _split(cpos, nrm[claim], cbmin, cbmax, depth + 1, max_tris,
                       max_depth, out)
