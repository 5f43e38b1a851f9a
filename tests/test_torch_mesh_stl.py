"""``scene/mesh_io.load_stl`` on STL files the tests write, and the
committed mirror of the DeepMind Control Suite dog
(``benchmark/scenes/dmc-dog-skin.json``, written by ``tools/dmc_dog.py``).

The mirror is read from the repository, not rebuilt from the STL, which a
test machine may lack: its triangle count and BVH route, every facet
front-facing from outside, its camera against ``dog.xml``'s ``y-axis``
camera, and the image it gives against that camera's in MuJoCo's own
frame (the head on the same side, not mirrored).
"""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tracing_extended_tpu_torch import load_json_scene
from ray_tracing_extended_tpu_torch.ops.camera import focus_points
from ray_tracing_extended_tpu_torch.scene.mesh_io import load_stl
from ray_tracing_extended_tpu_torch.tools import dmc_dog

MIRROR = Path(__file__).resolve().parents[1] / "benchmark" / "scenes" / \
    "dmc-dog-skin.json"
SKIN_TRIANGLES, FLOOR_TRIANGLES = 33900, 2

# dog.xml:336 and :339, and MuJoCo's default fovy
TORSO = np.array([0.040403, 0.0, 0.41522])
CAM_POS = np.array([0.0, -1.5, 0.8])
CAM_XYAXES = np.array([[1.0, 0.0, 0.0], [0.0, 0.6, 1.0]])
FOVY = 45.0

TETRA = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
# outward winding: each face's normal (b - a) x (c - a) points away
TETRA_FACES = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    workers on the CPU, and torch's default of a thread a core
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _facet_normals(corners):
    n = np.cross(corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0])
    return n / np.linalg.norm(n, axis=1, keepdims=True)


def _binary_stl(path, corners, normals):
    with open(path, "wb") as f:
        f.write(b"solid but binary".ljust(80, b"\0"))
        f.write(struct.pack("<I", len(corners)))
        for n, c in zip(normals, corners):
            f.write(struct.pack("<12fH", *n, *c.reshape(-1), 0))


def _ascii_stl(path, corners, normals):
    lines = ["solid test"]
    for n, c in zip(normals, corners):
        lines.append("  facet normal %r %r %r" % tuple(map(float, n)))
        lines.append("    outer loop")
        lines += ["      vertex %r %r %r" % tuple(map(float, p)) for p in c]
        lines += ["    endloop", "  endfacet"]
    lines.append("endsolid test")
    Path(path).write_text("\n".join(lines) + "\n")


def test_binary_tetrahedron_welds_its_corners_and_keeps_the_winding(tmp_path):
    corners = TETRA[TETRA_FACES]
    normals = _facet_normals(corners)
    _binary_stl(tmp_path / "t.stl", corners, normals)
    v, f, n = load_stl(tmp_path / "t.stl")
    assert v.dtype == np.float32 and f.dtype == np.int32
    # four vertices in the order of their first appearance
    np.testing.assert_array_equal(v, TETRA[[0, 2, 1, 3]])
    np.testing.assert_array_equal(v[f], corners)
    expected = np.zeros((4, 3))
    for face, fn in zip(f, normals):
        expected[face] += fn
    expected /= np.linalg.norm(expected, axis=1, keepdims=True)
    np.testing.assert_allclose(n, expected, rtol=1e-6, atol=1e-7)
    # the winding points out: positive signed volume
    a, b, c = (v[f][:, i].astype(np.float64) for i in range(3))
    assert np.einsum("ij,ij->i", a, np.cross(b, c)).sum() > 0


def test_ascii_quad_welds_the_shared_edge(tmp_path):
    quad = np.array([[0, 0, 0], [2, 0, 0], [2, 1, 0], [0, 1, 0]], np.float32)
    corners = quad[[[0, 1, 2], [0, 2, 3]]]
    corners[1, 0] = [-0.0, 0.0, -0.0]  # -0 welds with 0
    _ascii_stl(tmp_path / "q.stl", corners, np.zeros((2, 3)))
    v, f, n = load_stl(tmp_path / "q.stl")
    np.testing.assert_array_equal(v, quad)
    np.testing.assert_array_equal(f, [[0, 1, 2], [0, 2, 3]])
    # no stored normals: each facet gives its winding's
    np.testing.assert_array_equal(n, np.tile([0, 0, 1], (4, 1)))


@pytest.mark.parametrize("kind", ["binary", "ascii"])
def test_a_truncated_file_is_refused(tmp_path, kind):
    corners = TETRA[TETRA_FACES]
    path = tmp_path / "t.stl"
    (_binary_stl if kind == "binary" else _ascii_stl)(
        path, corners, _facet_normals(corners))
    data = path.read_bytes()
    path.write_bytes(data[:len(data) - 60])
    with pytest.raises(ValueError):
        load_stl(path)


def test_the_z_up_map_keeps_the_winding_outward():
    """``to_port`` is a reflection; with the last two corners swapped a
    facet's winding still points out of the solid."""
    corners = TETRA[TETRA_FACES] + np.float32([0.3, 0.2, 0.1])
    mapped = dmc_dog.to_port(corners)[:, [0, 2, 1]]
    n = _facet_normals(mapped)
    centre = mapped.reshape(-1, 3).mean(0)
    assert (np.einsum("ij,ij->i", n, mapped.mean(1) - centre) > 0).all()


@pytest.fixture(scope="module")
def dog():
    """The committed mirror on the CPU at a small size, and its raw
    groups."""
    scene, cam, cfg = load_json_scene(
        MIRROR, overrides=dict(width=48, height=27, spp=1, max_bounce=2),
        device="cpu")
    data = np.load(MIRROR.with_suffix(".npz"))
    return scene, cam, cfg, data["g000_pos"], data["g000_nrm"], \
        data["g001_pos"]


def test_the_mirror_takes_the_bvh_route(dog):
    scene, _, cfg, skin, _, floor = dog
    assert (len(skin), len(floor)) == (SKIN_TRIANGLES, FLOOR_TRIANGLES)
    assert int(scene.chunks.num_tris.sum()) == SKIN_TRIANGLES + FLOOR_TRIANGLES
    assert scene.tri_bvh is not None
    assert (cfg.max_bounce, cfg.spp) == (2, 1)


def test_every_facet_faces_out(dog):
    """Each skin facet's winding agrees with its corners' normals (the
    file's outward normals), the skin is closed with a positive volume, and
    the floor faces up."""
    _, _, _, skin, skin_nrm, floor = dog
    n = np.cross(skin[:, 1] - skin[:, 0], skin[:, 2] - skin[:, 0])
    assert (np.einsum("ij,ij->i", n, skin_nrm.sum(1)) > 0).all()
    a, b, c = (skin[:, i].astype(np.float64) for i in range(3))
    assert np.einsum("ij,ij->i", a, np.cross(b, c)).sum() > 0
    edges = np.concatenate([skin[:, [0, 1]], skin[:, [1, 2]],
                            skin[:, [2, 0]]]).reshape(-1, 6)
    fwd = {tuple(e) for e in edges}
    # a closed surface with a consistent winding: each directed edge once,
    # its reverse once
    assert len(fwd) == len(edges)
    assert all(e[3:] + e[:3] in fwd for e in fwd)
    fn = np.cross(floor[:, 1] - floor[:, 0], floor[:, 2] - floor[:, 0])
    assert (fn[:, 1] > 0).all() and (fn[:, [0, 2]] == 0).all()


def _mujoco_camera():
    """dog.xml's y-axis camera at rest: (position, right, up, forward)."""
    x = CAM_XYAXES[0] / np.linalg.norm(CAM_XYAXES[0])
    y = CAM_XYAXES[1] - x * (x @ CAM_XYAXES[1])
    y /= np.linalg.norm(y)
    return TORSO + CAM_POS, x, y, -np.cross(x, y)


def test_the_camera_is_dog_xml_y_axis_camera(dog):
    _, cam, _, _, _, _ = dog
    pos, right, up, fwd = _mujoco_camera()
    np.testing.assert_allclose(cam.position.numpy(), pos[[0, 2, 1]],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(cam.rotation.numpy(),
                               np.stack([right, up, fwd], -1)[[0, 2, 1]],
                               rtol=0, atol=1e-6)
    assert float(cam.fov_y_deg) == FOVY
    assert float(cam.defocus_strength) == 0.0
    assert float(cam.diverge_strength) == 1.0


def _first_hits(o, d, tri, block=16):
    """Two-sided nearest hit of rays (R, 3) on triangles (T, 3, 3) ->
    (t, the hit triangle's winding faces the ray), t inf on a miss."""
    a = tri[:, 0].astype(np.float64)
    e1 = tri[:, 1] - a
    e2 = tri[:, 2] - a
    t_out = np.full(len(o), np.inf)
    front = np.zeros(len(o), bool)
    for s in range(0, len(o), block):
        oo, dd = o[s:s + block, None], d[s:s + block, None]
        p = np.cross(dd, e2)
        det = np.einsum("rtk,tk->rt", p, e1)
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = oo - a
        u = np.einsum("rtk,rtk->rt", tv, p) * inv
        q = np.cross(tv, e1)
        v = np.einsum("rk,rtk->rt", d[s:s + block], q) * inv
        t = np.einsum("tk,rtk->rt", e2, q) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
        t = np.where(hit, t, np.inf)
        k = t.argmin(1)
        t_out[s:s + block] = t[np.arange(len(k)), k]
        # the kernel's front face: d . (e_ab x e_ac) < 0, det > 0 here
        front[s:s + block] = det[np.arange(len(k)), k] > 0
    return t_out, front


def _port_rays(cam, w, h):
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    fp = focus_points(cam, xs.reshape(-1), ys.reshape(-1), w, h).double()
    o = cam.position.double().expand_as(fp)
    d = fp - o
    return o.numpy(), (d / d.norm(dim=1, keepdim=True)).numpy()


def _mujoco_rays(w, h):
    """Pixel centres of MuJoCo's camera, row 0 the bottom as the port's."""
    pos, right, up, fwd = _mujoco_camera()
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    half = np.tan(np.radians(FOVY) / 2)
    u = ((xs.reshape(-1) + 0.5) / w - 0.5) * 2 * half * w / h
    v = ((ys.reshape(-1) + 0.5) / h - 0.5) * 2 * half
    d = fwd + u[:, None] * right + v[:, None] * up
    return np.broadcast_to(pos, d.shape), d / np.linalg.norm(d, axis=1,
                                                             keepdims=True)


def test_the_image_is_the_y_axis_camera_s_and_rays_meet_front_faces(dog):
    """The skin's silhouette through the mirror's camera equals the one
    through dog.xml's camera in MuJoCo's frame, and is not its mirror
    image; the nose (MuJoCo's +x end) is on the right; every camera ray
    that meets the skin meets a front face first."""
    _, cam, _, skin, _, _ = dog
    w, h = 48, 27
    o, d = _port_rays(cam, w, h)
    t, front = _first_hits(o, d, skin)
    mask = np.isfinite(t).reshape(h, w)
    assert 0.05 < mask.mean() < 0.5
    assert front[np.isfinite(t)].all()

    skin_mj = skin[:, [0, 2, 1]][..., [0, 2, 1]]  # the map undone
    o_mj, d_mj = _mujoco_rays(w, h)
    t_mj, _ = _first_hits(o_mj, d_mj, skin_mj)
    mask_mj = np.isfinite(t_mj).reshape(h, w)
    assert (mask != mask_mj).mean() < 0.01
    assert (mask != mask_mj[:, ::-1]).mean() > 0.05

    nose = skin_mj.reshape(-1, 3)[:, 0].argmax()
    tail = skin_mj.reshape(-1, 3)[:, 0].argmin()
    right = cam.rotation.numpy()[:, 0]
    p = skin.reshape(-1, 3)
    assert (p[nose] - cam.position.numpy()) @ right > 0
    assert (p[tail] - cam.position.numpy()) @ right < 0
