"""The path-trace kernel's two table routes: staged in a block's shared
memory, or read in place from global memory for a scene past
``MAX_SHARED_BYTES``.

On the CPU: the size rule (``launch_shared_bytes`` against bytes counted
by hand, the route of each shipped kind of scene and of the wide sphere
scenes), the route's names, and the wide scene itself, built by the same
rule in both packages and rendered by the port's plain path against the
JAX package's XLA path. On the card (marker ``cuda``, skipped without
one): the forced global route against the staged one bit for bit, and the
wide scene's kernel against its plain version. The JAX package is imported
inside the tests that need it, so that the card's tests also run where only
PyTorch is installed:

    python -m pytest tests/test_torch_global_tables.py -m cuda --noconftest -q
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import ray_tracing_extended_tpu_torch as rtt
from ray_tracing_extended_tpu_torch.kernels import megakernel as mk
from ray_tracing_extended_tpu_torch.models import presets as tpresets

from ray_tracing_extended_tpu_torch.models.wide_scenes import (
    HALF_100K,
    HALF_PAST_LIMIT,
    rtiow_camera_and_config,
    wide_sphere_builder,
    wide_sphere_scene,
)

SCENES = pathlib.Path(rtt.__file__).resolve().parent.parent / "scenes"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests (the suite runs several
    workers on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wide():
    """The wide sphere scene just past the limit, on the CPU."""
    return wide_sphere_scene(tpresets, HALF_PAST_LIMIT, device="cpu")


def _tables(scene, cfg):
    return mk.geometry_tables(scene, mk.geometry(scene, cfg))


def test_shared_bytes_counted_by_hand():
    """16 bytes a float4 row (a sphere; two a cluster, a chunk, a box over
    a run of chunks), 4 a parameter (32), a sphere's two indices and a
    bounce of the histogram; the global route keeps the last only."""
    scene, _, cfg = tpresets.cornell_box_scene(width=8, height=8,
                                               device="cpu")
    tab = _tables(scene, cfg)

    def rows(n):
        return torch.zeros((n, 8))

    tab = dataclasses.replace(tab, spheres=torch.zeros((10, 4)),
                              clusters=rows(2), chunks=rows(5), supers=rows(1))
    mb = 3
    params_hist = 4 * (32 + mb + 1)
    assert mk.launch_shared_bytes(tab, mb) == (
        16 * (10 + 2 * 2 + 2 * 5 + 2 * 1) + 4 * 2 * 10 + params_hist) == 640
    assert mk.launch_shared_bytes(tab, mb, "global") == params_hist == 144
    # only a chunk scan stages the chunk table
    for geom in ("spheres", "bvh"):
        assert mk.launch_shared_bytes(
            dataclasses.replace(tab, geometry=geom), mb) == 16 * 14 + 80 + 144
    with pytest.raises(ValueError):
        mk.launch_shared_bytes(tab, mb, "shared")


def _mesh():
    return tpresets.mesh_scene(device="cpu")


@pytest.mark.parametrize("name, make", [
    ("rtiow", lambda: tpresets.rtiow_final_scene(device="cpu")),
    ("cornell", lambda: tpresets.cornell_box_scene(device="cpu")),
    ("chess", lambda: rtt.load_json_scene(SCENES / "chess.json",
                                          device="cpu")),
    ("mesh", _mesh),
])
def test_shipped_scenes_route_staged(name, make):
    scene, _, cfg = make()
    tab = _tables(scene, cfg)
    assert mk.launch_shared_bytes(tab, cfg.max_bounce) <= mk.MAX_SHARED_BYTES
    assert mk.table_route(tab, cfg) == "staged"


def test_wide_sphere_scenes_route_global(wide):
    """14,401 spheres (about 360 KB of staged tables) and 99,857 (about
    2.5 MB) take the global route; so do such spheres around triangles, by
    chunk scan and by BVH: no geometry is refused for its size."""
    scene, _, cfg = wide
    tab = _tables(scene, cfg)
    assert int((scene.spheres.radius > 0).sum()) == 14401
    assert mk.launch_shared_bytes(tab, cfg.max_bounce) == 360172
    assert mk.table_route(tab, cfg) == "global"
    big, _, cfg = wide_sphere_scene(tpresets, HALF_100K, device="cpu")
    tab = _tables(big, cfg)
    assert int((big.spheres.radius > 0).sum()) == 99857
    assert mk.launch_shared_bytes(tab, cfg.max_bounce) == 2496588
    assert mk.table_route(tab, cfg) == "global"
    # triangles beside the wide spheres: a quad (chunk scan) or a knot
    # with its BVH
    b = wide_sphere_builder(tpresets, HALF_PAST_LIMIT)
    quad = np.array([[[0, 0, 0], [1, 0, 0], [1, 1, 0]],
                     [[0, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)
    b.add_triangles(quad, np.tile(np.float32([0, 0, 1]), (2, 3, 1)),
                    tpresets.Material.lambertian((0.5, 0.5, 0.5)))
    for build_bvh, geom in ((None, "chunks"), ("tri", "bvh")):
        scene = b.build(build_bvh=build_bvh, device="cpu")
        assert mk.geometry(scene, cfg) == geom
        assert mk.table_route(_tables(scene, cfg), cfg) == "global"


def test_route_changes_at_the_limit():
    """The rule by size: the grid's largest half-width whose tables fit a
    block stages them, the next one does not."""
    _, cfg = rtiow_camera_and_config(tpresets, device="cpu")

    def route(half):
        scene = wide_sphere_builder(tpresets, half).build(device="cpu")
        return mk.table_route(_tables(scene, cfg), cfg)

    assert route(48) == "staged" and route(49) == "global"  # 9,217 | 9,606


def test_variant_names_the_route():
    assert len(set(mk.GLOBAL_VARIANTS)) == 12
    assert not set(mk.GLOBAL_VARIANTS) & set(mk.VARIANTS + mk.PROBE_VARIANTS)
    assert mk.variant("spheres", tables="global") == (
        "render_kernel<kSpheres, kBoxMuller, kGlobal>")
    assert mk.variant("bvh", True, True, tables="global") == (
        "render_adaptive<kBvh, kFastScatter, kGlobal>")
    assert mk.variant("chunks", tables="staged") == "render_kernel<kChunks>"
    assert mk.variant("spheres", probe="dup_fetch", tables="global") == (
        "render_kernel<kSpheres, kBoxMuller, kDupFetch, kGlobal>")
    with pytest.raises(ValueError):
        mk.variant("spheres", tables="shared")


def test_forced_route_on_the_cpu_is_the_plain_path():
    scene, cam, cfg = tpresets.three_sphere_scene(width=16, height=8, spp=1,
                                                  device="cpu")
    ref = mk.render_frames_mega(scene, cam, cfg, 2)
    for tables in mk.TABLES:
        out = mk.render_frames_mega(scene, cam, cfg, 2, tables=tables)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    with pytest.raises(ValueError):
        mk.render_frames_mega(scene, cam, cfg, 2, tables="shared")
    assert mk.path_name(scene, cfg) == "plain closest_hit_clustered<spheres>"


def test_wide_scene_rule_at_rtiow_width_is_rtiow():
    """At RTIOW's half-width the rule builds RTIOW's scene exactly."""
    a = wide_sphere_scene(tpresets, 11, device="cpu")[0]
    b = tpresets.rtiow_final_scene(device="cpu")[0]
    for f in ("center", "radius", "mat_idx"):
        assert torch.equal(getattr(a.spheres, f), getattr(b.spheres, f))
    for f in ("colour", "smoothness", "specular_probability", "flag", "ior"):
        assert torch.equal(getattr(a.materials, f), getattr(b.materials, f))


def test_wide_scene_arrays_equal_across_packages(wide):
    from ray_tracing_extended_tpu.models import presets as jpresets

    scene = wide[0]
    j = wide_sphere_scene(jpresets, HALF_PAST_LIMIT)[0]
    for f in ("center", "radius", "mat_idx"):
        np.testing.assert_array_equal(getattr(scene.spheres, f).numpy(),
                                      np.asarray(getattr(j.spheres, f)))
    for f in ("colour", "emission_colour", "specular_colour",
              "emission_strength", "smoothness", "specular_probability",
              "ior", "flag"):
        np.testing.assert_array_equal(getattr(scene.materials, f).numpy(),
                                      np.asarray(getattr(j.materials, f)))


def test_wide_scene_frame_matches_xla(wide):
    """A 32x18 frame, 2 spp, 2 bounces of the scene past the limit: the
    port's plain path (the clustered scan, the kernel's function) against
    the JAX package's XLA path, by the rule of tests/test_megakernel.py
    (over 99.5% of pixels within 1e-3, mean |d| under 1e-3)."""
    import jax.numpy as jnp

    import ray_tracing_extended_tpu as rte
    from ray_tracing_extended_tpu.models import presets as jpresets

    scene, cam, _ = wide
    cfg = rtt.RenderConfig(width=32, height=18, max_bounce=2, spp=2,
                           clamp_accumulate=False)
    js, jc, _ = wide_sphere_scene(jpresets, HALF_PAST_LIMIT)
    a = np.asarray(rte.render_frame(js, jc, cfg, jnp.uint32(3)))
    b = rtt.render_frame(scene, cam, cfg, 3).numpy()
    d = np.abs(a - b).max(axis=-1)
    assert (d < 1e-3).mean() > 0.995, f"frac tight {(d < 1e-3).mean()}"
    assert np.abs(a - b).mean() < 1e-3
    assert np.isfinite(b).all() and b.mean() > 0.05


# ------------------------------- on the card --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _small(name, dev):
    if name == "rtiow":
        return tpresets.rtiow_final_scene(width=96, height=54, max_bounce=4,
                                          spp=4, device=dev)
    if name == "cornell":
        return tpresets.cornell_box_scene(width=64, height=64, device=dev)
    return tpresets.mesh_scene(width=96, height=54, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rtiow", "cornell", "mesh"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_forced_global_route_equals_staged(cuda, name, adaptive):
    """Both kernels on the global route, bit for bit the staged route:
    image, segment map and histogram, a frame and a K = 4 fold; each launch
    counted under its route's name."""
    scene, cam, cfg = _small(name, cuda)
    cfg = dataclasses.replace(cfg, adaptive_spp=adaptive)
    geom = mk.geometry(scene, cfg)
    assert mk.path_name(scene, cfg) == mk.variant(geom, adaptive)
    acc0 = torch.rand((cfg.height, cfg.width, 3), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(0))
    before = dict(mk.KERNEL.variant_launches)
    for args in ((3, 1, None), (1, 4, acc0)):
        staged = mk.render_frames_mega(scene, cam, cfg, *args,
                                       collect_stats=True)
        glob = mk.render_frames_mega(scene, cam, cfg, *args,
                                     collect_stats=True, tables="global")
        for x, y in zip(staged, glob):
            assert torch.equal(x, y)
    after = mk.KERNEL.variant_launches
    for tables in mk.TABLES:
        v = mk.variant(geom, adaptive, tables=tables)
        assert after[v] == before.get(v, 0) + 2 * mk.launches_per_call(cfg)


@pytest.mark.cuda
def test_wide_scene_kernel_matches_plain(cuda):
    """The scene past the limit through the kernel's global route against
    the plain version, bench.py's mb1 gate (median per-pixel rel. < 2e-3,
    channel means within 5e-3)."""
    scene, cam, cfg = wide_sphere_scene(tpresets, HALF_PAST_LIMIT, width=96,
                                        height=54, max_bounce=1, spp=8,
                                        device=cuda)
    cam = cam.replace(defocus_strength=0.0)
    v = mk.variant("spheres", tables="global")
    assert mk.path_name(scene, cfg) == v
    before = mk.KERNEL.variant_launches[v]
    k = mk.render_frames_mega(scene, cam, cfg, 5)[0]
    assert mk.KERNEL.variant_launches[v] == before + 1
    p = mk.render_frames_plain(scene, cam, cfg, 5)[0]
    k, p = k.double().cpu(), p.double().cpu()
    rel = ((k - p).abs() / (1.0 + p.abs())).amax(dim=-1)
    assert float(rel.median()) < 2e-3
    km, pm = k.mean((0, 1)), p.mean((0, 1))
    assert float(((km - pm).abs() / pm).max()) < 5e-3
