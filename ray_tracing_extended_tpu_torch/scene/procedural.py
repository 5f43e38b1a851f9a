"""Procedural test meshes (the repo ships no binary mesh assets).

A copy of ``ray_tracing_extended_tpu/scene/procedural.py`` (NumPy only), so
both packages make identical meshes. ``trefoil_knot_mesh`` produces a
smooth, self-occluding tube of any triangle budget - a stand-in for the
Stanford bunny in BASELINE config 4 (use ``scene/mesh_io.load_obj`` to load
the real bunny when available).
"""

from __future__ import annotations

import numpy as np


def trefoil_knot_mesh(target_tris: int = 70000, radius: float = 0.35):
    """Tube swept along a trefoil knot. Returns (vertices (V,3) f32,
    faces (F,3) int32) with F ~= target_tris, deterministic."""
    # tris = 2 * nu * nv; keep the tube ring at 64 segments
    nv = 64
    nu = max(8, int(round(target_tris / (2 * nv))))
    u = np.linspace(0.0, 2.0 * np.pi, nu, endpoint=False)
    # trefoil centerline
    cx = np.sin(u) + 2.0 * np.sin(2.0 * u)
    cy = np.cos(u) - 2.0 * np.cos(2.0 * u)
    cz = -np.sin(3.0 * u)
    c = np.stack([cx, cy, cz], axis=1)
    # Frenet-like frame via finite differences
    t = np.roll(c, -1, axis=0) - np.roll(c, 1, axis=0)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    ref = np.array([0.12, 0.35, 0.93])
    b = np.cross(t, ref)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    n = np.cross(b, t)

    v = np.linspace(0.0, 2.0 * np.pi, nv, endpoint=False)
    circ = np.stack([np.cos(v), np.sin(v)], axis=1)  # (nv, 2)
    verts = (
        c[:, None, :]
        + radius * (circ[None, :, 0:1] * n[:, None, :] + circ[None, :, 1:2] * b[:, None, :])
    ).reshape(-1, 3)

    faces = []
    for i in range(nu):
        i1 = (i + 1) % nu
        base0 = i * nv
        base1 = i1 * nv
        j = np.arange(nv)
        j1 = (j + 1) % nv
        quad_a = np.stack([base0 + j, base1 + j, base1 + j1], axis=1)
        quad_b = np.stack([base0 + j, base1 + j1, base0 + j1], axis=1)
        faces.append(quad_a)
        faces.append(quad_b)
    faces = np.concatenate(faces).astype(np.int32)
    return verts.astype(np.float32), faces


def uv_sphere_mesh(n_lat: int = 32, n_lon: int = 64, radius: float = 1.0):
    """Simple UV sphere (used in tests to cross-check mesh vs analytic
    sphere intersections)."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)
    verts = []
    for th in lat:
        for ph in lon:
            verts.append(
                [
                    radius * np.sin(th) * np.cos(ph),
                    radius * np.cos(th),
                    radius * np.sin(th) * np.sin(ph),
                ]
            )
    verts = np.asarray(verts, np.float32)
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            j1 = (j + 1) % n_lon
            a = i * n_lon + j
            b = i * n_lon + j1
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + j1
            faces.append([a, b, d])
            faces.append([a, d, c])
    return verts, np.asarray(faces, np.int32)
