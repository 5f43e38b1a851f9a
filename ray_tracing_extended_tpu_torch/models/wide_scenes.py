"""Sphere scenes wider than a thread block's shared memory: the RTIOW
cover scene's rule over a wider grid, for the tests, ``chip_smoke.py`` and
``tools/scan_ab.py``.

No preset of either package: neither has one this large. Every function
takes the ``presets`` module it builds through (this package's
``models.presets``, or the JAX package's in the tests, whose
``SceneBuilder``, ``Material``, ``look_at`` and ``RenderConfig`` are used),
so both packages build the same arrays from the same seed, and an older
tree of this package builds the same scene (``tools/scan_ab.py``). The
camera, sky and config are ``rtiow_final_scene``'s. NumPy only.
"""

from __future__ import annotations

import numpy as np

SEED = 20260816

# Half-widths of the grid: (2 half)^2 small spheres plus the ground and the
# three heroes. 60 -> 14,404 spheres, about 360 KB of staged tables (past a
# block's 227 KB); 158 -> 99,860 spheres, about 2.5 MB (L2-resident).
HALF_PAST_LIMIT = 60
HALF_100K = 158


def wide_sphere_builder(presets, half: int, seed=SEED):
    """``rtiow_final_scene``'s spheres with its loop over ``range(-half,
    half)`` in both axes (RTIOW's is ``half = 11``): a small sphere in each
    grid cell but the one at the metal hero, its material drawn by the same
    rule, in the package's ``SceneBuilder`` under RTIOW's sky."""
    rs = np.random.RandomState(seed)
    b = presets.SceneBuilder(env=presets._gradient_sky())
    mat = presets.Material
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, mat.lambertian((0.5, 0.5, 0.5)))
    for a in range(-half, half):
        for c in range(-half, half):
            choose = rs.rand()
            center = np.array(
                [a + 0.9 * rs.rand(), 0.2, c + 0.9 * rs.rand()], np.float32
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                m = mat.lambertian(tuple(rs.rand(3) * rs.rand(3)))
            elif choose < 0.95:
                albedo = 0.5 * (1.0 + rs.rand(3))
                fuzz = 0.5 * rs.rand()
                m = mat.metal(tuple(albedo), smoothness=1.0 - fuzz)
            else:
                m = mat.dielectric(1.5)
            b.add_sphere(tuple(center), 0.2, m)
    b.add_sphere((0.0, 1.0, 0.0), 1.0, mat.dielectric(1.5))
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, mat.lambertian((0.4, 0.2, 0.1)))
    b.add_sphere((4.0, 1.0, 0.0), 1.0, mat.metal((0.7, 0.6, 0.5), smoothness=1.0))
    return b


def rtiow_camera_and_config(presets, width=1920, height=1080, max_bounce=4,
                            spp=1, **device):
    """``rtiow_final_scene``'s camera and config."""
    cam = presets.look_at(
        (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), fov_y_deg=20.0, focus_distance=10.0,
        defocus_strength=20.0, diverge_strength=1.0, **device,
    )
    cfg = presets.RenderConfig(
        width=width, height=height, max_bounce=max_bounce, spp=spp,
        clamp_accumulate=False,
    )
    return cam, cfg


def wide_sphere_scene(presets, half: int, width=1920, height=1080,
                      max_bounce=4, spp=1, seed=SEED, **device):
    """``wide_sphere_builder``'s scene with RTIOW's camera and config ->
    ``(scene, camera, config)``. ``device`` (``device="cpu"``) goes to the
    port's builder and camera; the JAX package's take none."""
    b = wide_sphere_builder(presets, half, seed)
    cam, cfg = rtiow_camera_and_config(presets, width, height, max_bounce,
                                       spp, **device)
    return b.build(**device), cam, cfg
