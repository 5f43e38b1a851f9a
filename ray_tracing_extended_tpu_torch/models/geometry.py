"""Scene geometry as struct-of-array tensor dataclasses.

Mirrors ``ray_tracing_extended_tpu/models/geometry.py``: the reference's
``Spheres``, ``Triangles`` and ``AllMeshInfo`` buffers
(RayTracing.shader:110-115) as dense SoA tensors, with materials factored
out into one flat table indexed by primitive. Padding records are
un-hittable (radius -1 spheres, all-zero triangles whose Moller-Trumbore
determinant is 0), as ``models/scene.py`` builds them.

Every dataclass here holds tensors on one device and moves with
``.to(device)``.
"""

from __future__ import annotations

import dataclasses

import torch

# Material flags (RayTracing.shader:57-58 and RayTracingMaterial.cs:6-11),
# plus the dielectric extension (SURVEY.md section 5 quirk 6).
FLAG_NONE = 0
FLAG_CHECKER = 1
FLAG_INVISIBLE_LIGHT = 2
FLAG_DIELECTRIC = 3


class _Tensors:
    """``.to(device)`` for a dataclass whose fields are tensors or nested
    dataclasses of tensors."""

    def to(self, device):
        values = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return dataclasses.replace(
            self,
            **{
                k: v.to(device) if hasattr(v, "to") else v
                for k, v in values.items()
            },
        )

    @property
    def device(self) -> torch.device:
        first = getattr(self, dataclasses.fields(self)[0].name)
        return first.device


@dataclasses.dataclass(frozen=True)
class Materials(_Tensors):
    """Flat material table (RayTracingMaterial.cs:13-19 plus ``ior``)."""

    colour: torch.Tensor  # (M, 3) f32
    emission_colour: torch.Tensor  # (M, 3) f32
    specular_colour: torch.Tensor  # (M, 3) f32
    emission_strength: torch.Tensor  # (M,) f32
    smoothness: torch.Tensor  # (M,) f32
    specular_probability: torch.Tensor  # (M,) f32
    flag: torch.Tensor  # (M,) int32
    ior: torch.Tensor  # (M,) f32 (1.0 except for dielectrics)

    def take(self, idx: torch.Tensor) -> "Materials":
        """Gather material rows by index (any index shape)."""
        idx = idx.long()
        return Materials(
            **{
                f.name: getattr(self, f.name)[idx]
                for f in dataclasses.fields(self)
            }
        )

    @property
    def count(self) -> int:
        return self.colour.shape[0]


@dataclasses.dataclass(frozen=True)
class Spheres(_Tensors):
    """Sphere buffer (Sphere.cs:3-8). Padding spheres have radius <= 0."""

    center: torch.Tensor  # (S, 3) f32
    radius: torch.Tensor  # (S,) f32
    mat_idx: torch.Tensor  # (S,) int32

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class Triangles(_Tensors):
    """Flat triangle buffer (Triangle.cs:5-24) with the per-triangle
    Moller-Trumbore constants precomputed at build:
    ``n = cross(edge_ab, edge_ac)``, ``n_dot_a = dot(n, pos_a)``,
    ``cross_eac_a = cross(edge_ac, pos_a)``,
    ``cross_eab_a = cross(edge_ab, pos_a)``. Padding triangles are all
    zero, so their determinant is 0 and they never hit."""

    pos_a: torch.Tensor  # (T, 3) f32
    edge_ab: torch.Tensor  # (T, 3) f32
    edge_ac: torch.Tensor  # (T, 3) f32
    normal_a: torch.Tensor  # (T, 3) f32 per-vertex shading normals
    normal_b: torch.Tensor  # (T, 3) f32
    normal_c: torch.Tensor  # (T, 3) f32
    n: torch.Tensor  # (T, 3) f32
    n_dot_a: torch.Tensor  # (T,) f32
    cross_eac_a: torch.Tensor  # (T, 3) f32
    cross_eab_a: torch.Tensor  # (T, 3) f32
    mat_idx: torch.Tensor  # (T,) int32

    @property
    def count(self) -> int:
        return self.pos_a.shape[0]


@dataclasses.dataclass(frozen=True)
class MeshChunks(_Tensors):
    """Per-chunk records (MeshInfo.cs:3-20): a slice of the triangle buffer
    plus its world AABB. The brute-force path scans every triangle, which
    the conservative slab gate makes equivalent."""

    first_tri: torch.Tensor  # (C,) int32
    num_tris: torch.Tensor  # (C,) int32
    bounds_min: torch.Tensor  # (C, 3) f32
    bounds_max: torch.Tensor  # (C, 3) f32
    mat_idx: torch.Tensor  # (C,) int32


@dataclasses.dataclass(frozen=True)
class BVH(_Tensors):
    """Flat LBVH over primitives (``accel/bvh.py``), the JAX package's
    ``BVH``: built on the host, traversed with a fixed-size stack a ray.
    Every leaf owns exactly ``leaf_width`` slots of ``leaf_prims``; unused
    slots hold a sentinel index, the scene's first padding (never-hit)
    primitive. The root is node 0."""

    bounds_min: torch.Tensor  # (N, 3) f32 node AABB
    bounds_max: torch.Tensor  # (N, 3) f32
    left: torch.Tensor  # (N,) int32 child index (-1 for leaves)
    right: torch.Tensor  # (N,) int32
    leaf_row: torch.Tensor  # (N,) int32 row into leaf_prims, -1 internal
    leaf_prims: torch.Tensor  # (L, leaf_width) int32 primitive indices


@dataclasses.dataclass(frozen=True)
class Environment(_Tensors):
    """Sky/ground/sun settings (EnvironmentSettings.cs:3-12).
    ``sun_dir`` is the unit vector toward the sun."""

    enabled: torch.Tensor  # () f32 (0.0 / 1.0)
    ground_colour: torch.Tensor  # (3,) f32
    sky_colour_horizon: torch.Tensor  # (3,) f32
    sky_colour_zenith: torch.Tensor  # (3,) f32
    sun_focus: torch.Tensor  # () f32
    sun_intensity: torch.Tensor  # () f32
    sun_dir: torch.Tensor  # (3,) f32

    @staticmethod
    def disabled() -> "Environment":
        z3 = torch.zeros(3, dtype=torch.float32)
        return Environment(
            enabled=torch.tensor(0.0),
            ground_colour=z3,
            sky_colour_horizon=z3,
            sky_colour_zenith=z3,
            sun_focus=torch.tensor(1.0),
            sun_intensity=torch.tensor(0.0),
            sun_dir=torch.tensor([0.0, 1.0, 0.0]),
        )


@dataclasses.dataclass(frozen=True)
class Scene(_Tensors):
    """A complete scene on one device: the analog of the reference's bound
    buffers and uniforms (RayTracingManager.cs:111-124,159-163,184-186)."""

    spheres: Spheres
    triangles: Triangles
    chunks: MeshChunks
    materials: Materials
    env: Environment
    # True when any triangle can be hit (padding triangles are all zero, so
    # their geometric normal is zero). Worked out once where the scene is
    # made and carried through ``.to(device)``, so no render call has to
    # read it back from the device.
    has_triangles: bool | None = None
    # Optional acceleration structures (None: brute force / chunk scan).
    tri_bvh: BVH | None = None
    sphere_bvh: BVH | None = None

    def __post_init__(self):
        if self.has_triangles is None:
            object.__setattr__(
                self, "has_triangles",
                bool(torch.any(self.triangles.n != 0.0)),
            )

    @property
    def has_tri_bvh(self) -> bool:
        """Whether the triangles carry a BVH: a host fact, so the kernel's
        instantiation is picked without reading the device."""
        return self.tri_bvh is not None
