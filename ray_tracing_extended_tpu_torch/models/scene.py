"""Host-side scene construction (RayTracingManager.CreateSpheres /
CreateMeshes, RayTracingManager.cs:135-187).

Mirrors ``ray_tracing_extended_tpu/models/scene.py``. ``build()`` flattens
the builder into SoA tensors with the JAX package's padding and order
rules, so both packages build identical arrays from the same calls, and
puts them on ``device`` (the card unless the caller asks for the CPU):

  * spheres padded to a multiple of 128 with radius -1 (never hit), at
    least one padding slot;
  * one flat triangle buffer padded the same way with all-zero triangles
    (determinant 0, never hit);
  * one flat material table: sphere materials first, then one per triangle
    chunk, in insertion order (the spheres-then-triangles tie-break order).

Meshes added with ``add_mesh`` are octree-chunked once in local space
(``accel/chunks.py``) and re-posed per build, as in the JAX package.
``build(build_bvh=...)`` adds LBVHs over the triangles and / or spheres
(``accel/bvh.py``). The TPU kernel's packed tables and the content hash
are not part of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..accel.bvh import build_lbvh
from ..accel.chunks import MAX_TRIS_PER_CHUNK, create_chunks
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.profiling import SCENE_BVH_BUILD, annotate
from .geometry import (
    FLAG_DIELECTRIC,
    FLAG_NONE,
    Environment,
    Materials,
    MeshChunks,
    Scene,
    Spheres,
    Triangles,
)

_LANE = 128  # primitive counts pad to a multiple of this


@dataclasses.dataclass
class Material:
    """Host material with the reference's defaults
    (RayTracingMaterial.SetDefaultValues, RayTracingMaterial.cs:21-28). The
    default specularProbability is 1, so throughput multiplies
    specularColour for default materials (SURVEY.md section 5 quirk 5)."""

    colour: tuple = (1.0, 1.0, 1.0)
    emission_colour: tuple = (1.0, 1.0, 1.0)
    specular_colour: tuple = (1.0, 1.0, 1.0)
    emission_strength: float = 0.0
    smoothness: float = 0.0
    specular_probability: float = 1.0
    flag: int = FLAG_NONE
    ior: float = 1.0  # dielectric extension (flag 3)

    @staticmethod
    def lambertian(colour, smoothness: float = 0.0):
        """Plain diffuse: the specular lottery never fires."""
        return Material(
            colour=tuple(colour), specular_probability=0.0, smoothness=smoothness
        )

    @staticmethod
    def metal(colour, smoothness: float = 1.0, specular_colour=None):
        return Material(
            colour=tuple(colour),
            specular_colour=tuple(specular_colour or colour),
            specular_probability=1.0,
            smoothness=smoothness,
        )

    @staticmethod
    def emissive(colour, strength: float):
        return Material(
            colour=(0.0, 0.0, 0.0),
            emission_colour=tuple(colour),
            emission_strength=strength,
            specular_probability=0.0,
        )

    @staticmethod
    def dielectric(ior: float = 1.5, colour=(1.0, 1.0, 1.0)):
        return Material(colour=tuple(colour), flag=FLAG_DIELECTRIC, ior=ior)


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


class SceneBuilder:
    """Mutable host scene; ``build()`` may run once for a static scene or
    once per frame for animation (``set_sphere`` and
    ``set_mesh_transform`` between builds)."""

    def __init__(self, env: Environment | None = None):
        self._sphere_center: list = []
        self._sphere_radius: list = []
        self._sphere_mat: list[Material] = []
        # triangle sources in insertion order (the material table and the
        # spheres-then-chunks tie-break order follow it):
        # ("raw", tri_pos, tri_normal, bmin, bmax, Material) for a soup,
        # ("mesh", i) for self._meshes[i]
        self._sources: list = []
        # meshes keep their LOCAL geometry, so a transform can change
        # between builds; "cache" holds the world chunks of one transform
        self._meshes: list[dict] = []
        self.env = env if env is not None else Environment.disabled()

    def add_sphere(self, center, radius: float, material: Material):
        """One sphere record (Sphere.cs:3-8)."""
        self._sphere_center.append(np.asarray(center, np.float32))
        self._sphere_radius.append(np.float32(radius))
        self._sphere_mat.append(material)
        return self

    def set_sphere(self, index: int, center=None, radius=None, material=None):
        """Move, resize or re-skin sphere ``index`` (in ``add_sphere``
        order) before the next ``build()``."""
        if not 0 <= index < len(self._sphere_center):
            raise IndexError(
                f"sphere index {index} out of range "
                f"[0, {len(self._sphere_center)})"
            )
        if center is not None:
            self._sphere_center[index] = np.asarray(center, np.float32)
        if radius is not None:
            self._sphere_radius[index] = np.float32(radius)
        if material is not None:
            self._sphere_mat[index] = material
        return self

    def add_mesh(
        self,
        vertices,
        indices,
        material: Material,
        normals=None,
        transform=None,
        max_tris_per_chunk: int = MAX_TRIS_PER_CHUNK,
        chunked: bool = True,
    ):
        """A triangle mesh, octree-chunked and placed in the world.

        ``vertices`` (V, 3); ``indices`` (F, 3) ints; ``normals`` (V, 3), or
        None for area-weighted vertex normals; ``transform`` an optional
        (4, 4) local-to-world matrix. ``chunked=False`` keeps the mesh as one
        chunk."""
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        if normals is None:
            normals = _vertex_normals(vertices, indices)
        self._meshes.append({
            "vertices": vertices,
            "indices": indices,
            "normals": np.asarray(normals, np.float32),
            "material": material,
            "transform": None if transform is None
            else np.asarray(transform, np.float32),
            "max_tris": max_tris_per_chunk,
            "chunked": chunked,
            "local_chunks": None,  # [(tri_pos, tri_normal)] in local space
            "cache": None,  # (transform bytes, [chunk tuples])
        })
        self._sources.append(("mesh", len(self._meshes) - 1))
        return self

    def set_mesh_transform(self, index: int, transform):
        """Re-pose mesh ``index`` (in ``add_mesh`` order) before the next
        ``build()``, as moving a mesh's Transform does in the reference
        (RayTracedMesh.cs:42-51)."""
        if not 0 <= index < len(self._meshes):
            raise IndexError(
                f"mesh index {index} out of range [0, {len(self._meshes)})"
            )
        self._meshes[index]["transform"] = (
            None if transform is None else np.asarray(transform, np.float32)
        )
        return self

    def _mesh_chunks(self, rec: dict) -> list:
        """World-space chunk tuples of one mesh.

        The octree split runs once, in local space; each build re-transforms
        the cached chunks and takes tight world bounds from the transformed
        vertices (RayTracedMesh.cs:24-29,60-84). So the chunk count and
        membership do not change with the pose."""
        transform = rec["transform"]
        key = b"id" if transform is None else transform.tobytes()
        if rec["cache"] is not None and rec["cache"][0] == key:
            return rec["cache"][1]
        if rec["local_chunks"] is None:
            tri_pos_l = rec["vertices"][rec["indices"]]  # (F, 3, 3)
            tri_nrm_l = rec["normals"][rec["indices"]]
            if rec["chunked"]:
                rec["local_chunks"] = [
                    (ch.tri_pos, ch.tri_normal)
                    for ch in create_chunks(
                        tri_pos_l, tri_nrm_l, max_tris=rec["max_tris"]
                    )
                ]
            else:
                rec["local_chunks"] = [(tri_pos_l, tri_nrm_l)]
        if transform is not None:
            r = transform[:3, :3]
            t = transform[:3, 3]
            # normals take the inverse transpose of the linear part
            n_mat = np.linalg.inv(r).T
        out = []
        for tri_pos, tri_normal in rec["local_chunks"]:
            if transform is not None:
                tri_pos = tri_pos @ r.T + t
                tri_normal = tri_normal @ n_mat.T
                tri_normal = tri_normal / np.maximum(
                    np.linalg.norm(tri_normal, axis=2, keepdims=True), 1e-20
                )
                tri_pos = np.ascontiguousarray(tri_pos, np.float32)
                tri_normal = np.ascontiguousarray(tri_normal, np.float32)
            flat = tri_pos.reshape(-1, 3)
            out.append((tri_pos, tri_normal, flat.min(axis=0),
                        flat.max(axis=0), rec["material"]))
        rec["cache"] = (key, out)
        return out

    def add_triangles(self, tri_pos, tri_normal, material: Material):
        """A raw triangle soup, (F, 3, 3) positions and normals, as one
        chunk."""
        tri_pos = np.asarray(tri_pos, np.float32)
        tri_normal = np.asarray(tri_normal, np.float32)
        bmin = tri_pos.reshape(-1, 3).min(axis=0)
        bmax = tri_pos.reshape(-1, 3).max(axis=0)
        self._sources.append(("raw", tri_pos, tri_normal, bmin, bmax, material))
        return self

    def _iter_chunks(self):
        """Every chunk tuple in insertion order (soups and mesh chunks)."""
        for src in self._sources:
            if src[0] == "raw":
                yield src[1:]
            else:
                yield from self._mesh_chunks(self._meshes[src[1]])

    def build(
        self, build_bvh: str | None = None, device=DEFAULT_DEVICE
    ) -> Scene:
        """Flatten into a ``Scene`` on ``device`` (default the card; raises
        where CUDA is not available unless ``device="cpu"``).

        ``build_bvh`` is None, ``"tri"``, ``"sphere"`` or ``"both"``: an
        LBVH over the real triangles and / or spheres, its leaves padded
        with the first padding primitive (never hit), as in the JAX
        package. On the card a triangle BVH takes the kernel's BVH
        instantiation; without one the triangles are scanned by chunk."""
        dev = resolve_device(device)
        if build_bvh not in (None, "tri", "sphere", "both"):
            raise ValueError(f"unknown build_bvh {build_bvh!r}")
        s = len(self._sphere_center)
        s_pad = _round_up(s + 1, _LANE)
        centers = np.zeros((s_pad, 3), np.float32)
        radii = np.full((s_pad,), -1.0, np.float32)
        if s:
            centers[:s] = np.stack(self._sphere_center)
            radii[:s] = np.array(self._sphere_radius, np.float32)

        mats: list[Material] = list(self._sphere_mat)
        sphere_mat_idx = np.arange(s, dtype=np.int32)

        chunk_first, chunk_count, chunk_bmin, chunk_bmax = [], [], [], []
        chunk_mat_idx, tri_pos_all, tri_nrm_all, tri_mat_idx = [], [], [], []
        cursor = 0
        for tri_pos, tri_nrm, bmin, bmax, mat in self._iter_chunks():
            mats.append(mat)
            midx = len(mats) - 1
            n = tri_pos.shape[0]
            chunk_first.append(cursor)
            chunk_count.append(n)
            chunk_bmin.append(bmin)
            chunk_bmax.append(bmax)
            chunk_mat_idx.append(midx)
            tri_pos_all.append(tri_pos)
            tri_nrm_all.append(tri_nrm)
            tri_mat_idx.append(np.full((n,), midx, np.int32))
            cursor += n

        t = cursor
        t_pad = _round_up(t + 1, _LANE)
        pos = np.zeros((t_pad, 3, 3), np.float32)
        nrm = np.zeros((t_pad, 3, 3), np.float32)
        tmat = np.zeros((t_pad,), np.int32)
        if t:
            pos[:t] = np.concatenate(tri_pos_all)
            nrm[:t] = np.concatenate(tri_nrm_all)
            tmat[:t] = np.concatenate(tri_mat_idx)

        c = len(chunk_first)
        c_pad = max(1, c)
        chunks = MeshChunks(
            first_tri=_t(np.array(chunk_first + [0] * (c_pad - c), np.int32)),
            num_tris=_t(np.array(chunk_count + [0] * (c_pad - c), np.int32)),
            bounds_min=_t(np.array(
                chunk_bmin + [[1e30] * 3] * (c_pad - c), np.float32
            )),
            bounds_max=_t(np.array(
                chunk_bmax + [[1e30] * 3] * (c_pad - c), np.float32
            )),
            mat_idx=_t(np.array(chunk_mat_idx + [0] * (c_pad - c), np.int32)),
        )

        if not mats:
            mats = [Material()]
            sphere_mat_idx = np.zeros((0,), np.int32)
        smat = np.zeros((s_pad,), np.int32)
        if s:
            smat[:s] = sphere_mat_idx

        # every index the renderer gathers must be a real material row
        n_mats = len(mats)
        if not (0 <= smat.min() and smat.max() < n_mats
                and 0 <= tmat.min() and tmat.max() < n_mats):
            raise ValueError(f"material index out of range [0, {n_mats})")

        tri_bvh = sphere_bvh = None
        if build_bvh in ("tri", "both") and t:
            with annotate(SCENE_BVH_BUILD):
                tri_bvh = build_lbvh(pos[:t].min(axis=1),
                                     pos[:t].max(axis=1), sentinel=t)
        if build_bvh in ("sphere", "both") and s:
            with annotate(SCENE_BVH_BUILD):
                sphere_bvh = build_lbvh(centers[:s] - radii[:s, None],
                                        centers[:s] + radii[:s, None],
                                        sentinel=s)

        return Scene(
            spheres=Spheres(center=_t(centers), radius=_t(radii), mat_idx=_t(smat)),
            triangles=_triangles_soa(pos, nrm, tmat),
            chunks=chunks,
            materials=_materials_soa(mats),
            env=self.env,
            tri_bvh=tri_bvh,
            sphere_bvh=sphere_bvh,
        ).to(dev)


def _vertex_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for meshes that ship without them."""
    v0, v1, v2 = (vertices[indices[:, i]] for i in range(3))
    face_n = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(out, indices[:, i], face_n)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)


def _materials_soa(mats: Sequence[Material]) -> Materials:
    def arr(get):
        return _t(np.array([get(m) for m in mats], np.float32))

    return Materials(
        colour=arr(lambda m: m.colour[:3]),
        emission_colour=arr(lambda m: m.emission_colour[:3]),
        specular_colour=arr(lambda m: m.specular_colour[:3]),
        emission_strength=arr(lambda m: m.emission_strength),
        smoothness=arr(lambda m: m.smoothness),
        specular_probability=arr(lambda m: m.specular_probability),
        flag=_t(np.array([m.flag for m in mats], np.int32)),
        ior=arr(lambda m: m.ior),
    )


def _triangles_soa(pos: np.ndarray, nrm: np.ndarray, mat_idx: np.ndarray) -> Triangles:
    """The per-triangle Moller-Trumbore constants (see ``Triangles``),
    computed in numpy exactly as the JAX package computes them."""
    a, b, c = pos[:, 0], pos[:, 1], pos[:, 2]
    e_ab = b - a
    e_ac = c - a
    n = np.cross(e_ab, e_ac)
    return Triangles(
        pos_a=_t(a),
        edge_ab=_t(e_ab),
        edge_ac=_t(e_ac),
        normal_a=_t(nrm[:, 0]),
        normal_b=_t(nrm[:, 1]),
        normal_c=_t(nrm[:, 2]),
        n=_t(n),
        n_dot_a=_t(np.sum(n * a, axis=1)),
        cross_eac_a=_t(np.cross(e_ac, a)),
        cross_eab_a=_t(np.cross(e_ab, a)),
        mat_idx=_t(mat_idx),
    )
