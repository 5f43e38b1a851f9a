"""A triangle scene of any chunk count, for the chunk scan's box levels
(``kernels/megakernel.super_levels``): the tests build it at the counts
where the levels change, on the CPU or the card.

    from chunk_scenes import tile_scene
    scene, cam, cfg = tile_scene(65, device="cpu", width=64, height=36)
"""

import numpy as np

from ray_tracing_extended_tpu_torch.models.scene import Material, SceneBuilder
from ray_tracing_extended_tpu_torch.ops.camera import look_at
from ray_tracing_extended_tpu_torch.utils.config import RenderConfig


def tile_scene(n_chunks, device="cpu", width=64, height=36, spp=1,
               max_bounce=4, seed=5):
    """``n_chunks`` tiles scattered in front of a camera, each one chunk: a
    flat pyramid of four triangles that faces the camera (the triangle test
    culls back faces), of a size and tilt drawn from ``seed``. Most tiles
    are diffuse, every seventh metal, every fifth a light (the environment
    is off). Tiles lie along a slow spiral in index order, so a run of
    consecutive chunks is compact and its neighbours nearby, as an
    octree's chunks of a mesh are. -> ``(scene, camera, config)``."""
    rs = np.random.RandomState(seed)
    b = SceneBuilder()
    for k in range(n_chunks):
        a = 0.35 * k
        r = 0.4 + 2.2 * k / max(n_chunks, 1)
        centre = np.array([r * np.cos(a), 0.7 * r * np.sin(a),
                           rs.uniform(0.0, 3.0)], np.float32)
        size = rs.uniform(0.4, 0.9)
        apex = centre + np.array([0.0, 0.0, -rs.uniform(0.05, 0.3)],
                                 np.float32)
        rim = [centre + size * np.array([np.cos(t), np.sin(t), 0.0], np.float32)
               for t in np.pi / 4 + np.arange(4) * np.pi / 2]
        tris = np.stack([np.stack([apex, rim[i], rim[(i + 1) % 4]])
                         for i in range(4)]).astype(np.float32)
        nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        if (nrm[:, 2] > 0).any():
            tris = tris[:, ::-1].copy()
            nrm = -nrm
        nrm = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
        if k % 5 == 0:
            mat = Material.emissive((1.0, 0.9, 0.8), 4.0)
        elif k % 7 == 0:
            mat = Material.metal((0.8, 0.8, 0.9), smoothness=0.9)
        else:
            mat = Material.lambertian(tuple(rs.uniform(0.2, 0.9, 3)))
        b.add_triangles(tris, np.repeat(nrm[:, None, :], 3, axis=1), mat)
    cam = look_at((0.0, 0.0, -4.0), (0.0, 0.0, 1.0), fov_y_deg=45.0,
                  focus_distance=5.0, defocus_strength=0.0,
                  diverge_strength=1.0, device=device)
    cfg = RenderConfig(width=width, height=height, max_bounce=max_bounce,
                       spp=spp, clamp_accumulate=False)
    return b.build(device=device), cam, cfg
