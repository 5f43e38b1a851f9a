"""The benchmark's plain reference: a path tracer in plain PyTorch.

It imports torch and numpy only, nothing of the program under test. It
rebuilds each scene from the benchmark's raw inputs (the book's random
layout from the seed, or a scene file's triangles), and traces chosen
pixels of chosen frames with the arithmetic the CUDA kernel states: the
PCG hash and its samplers, the thin-lens camera, the brute-force closest
hit in the kernel's direct test forms (the nearest primitive wins, the
lower index on a tie, a triangle only if strictly nearer than the best
sphere), the specular-lottery and dielectric scatter, Russian roulette,
the sky, and the running average ``prev * (1 - w) + cur * w`` with
``w = 1 / (frame + 1)``. Every operation is written out in the order the
kernel rounds it (the kernel is built without fused multiply-adds), and
its minima and maxima drop a NaN operand as the kernel's ``fminf`` and
``fmaxf`` do (a uniform draw of exactly 0 sends a Box-Muller direction to
NaN about once in 2^32 draws; the sky then reads the ground colour), so
on the card the paths come out bit for bit.

Lanes are (pixel, frame) pairs. A lane traces its frame's ``spp`` samples
one after another from one RNG stream; the tracer runs every lane a
segment a step, a dead lane starting its next sample, so a step costs what
its live lanes cost.

``dtype`` other than float32 computes every float in that type: the
check's control (``control.py``), the reference in a precision below the
configuration's.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

MASK = 0xFFFFFFFF
PCG_MUL = 747796405
PCG_INC = 2891336453
PCG_OUT = 277803737
FRAME_STRIDE = 719393
PI_LOWP = float(np.float32(3.1415))
PI_BOXMULLER = float(np.float32(3.1415926))
INV_U32_MAX = float(np.float32(1.0) / np.float32(4294967295.0))
DET_EPS = 1e-6
DIELECTRIC_EPS = 1e-4
PASSTHROUGH_EPS = 0.001
FLAG_CHECKER, FLAG_INVISIBLE_LIGHT, FLAG_DIELECTRIC = 1, 2, 3
INF = float("inf")

# The least work of a segment's closest hit (``ops_per_segment``): FP32
# operations of one sphere test, one box (slab) test and one triangle test.
OPS_SPHERE, OPS_BOX, OPS_TRIANGLE = 16, 12, 34
GROUP = 32  # spheres a cluster, and boxes a super box, in the counted scan


@dataclasses.dataclass
class RefScene:
    """Struct-of-arrays scene on the host (numpy), as the raw inputs give
    it. ``chunks``: (first, count) of each group of triangles."""

    sph_center: np.ndarray  # (S, 3) f32
    sph_radius: np.ndarray  # (S,) f32
    sph_mat: np.ndarray  # (S,) int
    tri_pos: np.ndarray  # (T, 3, 3) f32
    tri_nrm: np.ndarray  # (T, 3, 3) f32
    tri_mat: np.ndarray  # (T,) int
    chunks: list
    materials: dict  # name -> (M, ...) array
    env: dict  # name -> array


@dataclasses.dataclass
class RefCamera:
    position: np.ndarray
    rotation: np.ndarray  # columns right, up, forward
    fov_y_deg: float
    focus_distance: float
    defocus_strength: float
    diverge_strength: float


def _material(colour=(1, 1, 1), emission_colour=(1, 1, 1),
              specular_colour=(1, 1, 1), emission_strength=0.0,
              smoothness=0.0, specular_probability=1.0, flag=0, ior=1.0):
    """One material row with the Unity component's defaults."""
    return dict(colour=colour, emission_colour=emission_colour,
                specular_colour=specular_colour,
                emission_strength=emission_strength, smoothness=smoothness,
                specular_probability=specular_probability, flag=flag, ior=ior)


def _material_table(rows) -> dict:
    def f32(key):
        return np.array([r[key] for r in rows], np.float32)

    table = {k: f32(k) for k in ("colour", "emission_colour",
                                 "specular_colour", "emission_strength",
                                 "smoothness", "specular_probability", "ior")}
    table["flag"] = np.array([r["flag"] for r in rows], np.int32)
    return table


def _scene(centers, radii, sph_rows, tri_pos, tri_nrm, tri_rows, env,
           chunks) -> RefScene:
    # the material table: one row a sphere, then one a triangle group
    sph_mat = np.arange(len(sph_rows))
    tri_mat = np.zeros(len(tri_pos), np.int64)
    mats = list(sph_rows)
    for (first, count), row in zip(chunks, tri_rows):
        tri_mat[first:first + count] = len(mats)
        mats.append(row)
    if not mats:
        mats = [_material()]
    return RefScene(
        sph_center=np.asarray(centers, np.float32).reshape(-1, 3),
        sph_radius=np.asarray(radii, np.float32).reshape(-1),
        sph_mat=sph_mat, tri_pos=np.asarray(tri_pos, np.float32).reshape(-1, 3, 3),
        tri_nrm=np.asarray(tri_nrm, np.float32).reshape(-1, 3, 3),
        tri_mat=tri_mat, chunks=list(chunks), materials=_material_table(mats),
        env=env)


def _look_at(position, target, up, **lens) -> RefCamera:
    position = np.asarray(position, np.float32)
    target = np.asarray(target, np.float32)
    up_hint = np.asarray(up, np.float32)

    def nrm(v):
        return v / float(np.linalg.norm(v))

    fwd = nrm(target - position)
    right = nrm(np.cross(up_hint, fwd))
    up_v = np.cross(fwd, right)
    rotation = np.stack([right, up_v, fwd], axis=-1).astype(np.float32)
    return RefCamera(position=position, rotation=rotation, **lens)


def rtiow_final(seed: int):
    """The cover scene of *Ray Tracing in One Weekend*, drawn from
    ``seed`` with the book's rule (``np.random.RandomState``): a ground
    sphere, the 22 x 22 grid of r = 0.2 spheres (80% diffuse, 15% metal,
    5% glass, none within 0.9 of (4, 0.2, 0)) and three r = 1 spheres; a
    white-to-blue sky -> ``(RefScene, RefCamera)``."""
    rs = np.random.RandomState(seed)
    centers, radii, rows = [(0.0, -1000.0, 0.0)], [1000.0], [
        _material(colour=(0.5, 0.5, 0.5), specular_probability=0.0)]
    for a in range(-11, 11):
        for c in range(-11, 11):
            choose = rs.rand()
            center = np.array([a + 0.9 * rs.rand(), 0.2, c + 0.9 * rs.rand()],
                              np.float32)
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = tuple(rs.rand(3) * rs.rand(3))
                row = _material(colour=albedo, specular_probability=0.0)
            elif choose < 0.95:
                albedo = tuple(0.5 * (1.0 + rs.rand(3)))
                fuzz = 0.5 * rs.rand()
                row = _material(colour=albedo, specular_colour=albedo,
                                specular_probability=1.0,
                                smoothness=1.0 - fuzz)
            else:
                row = _material(flag=FLAG_DIELECTRIC, ior=1.5)
            centers.append(center)
            radii.append(0.2)
            rows.append(row)
    for center, row in (
            ((0.0, 1.0, 0.0), _material(flag=FLAG_DIELECTRIC, ior=1.5)),
            ((-4.0, 1.0, 0.0), _material(colour=(0.4, 0.2, 0.1),
                                         specular_probability=0.0)),
            ((4.0, 1.0, 0.0), _material(colour=(0.7, 0.6, 0.5),
                                        specular_colour=(0.7, 0.6, 0.5),
                                        specular_probability=1.0,
                                        smoothness=1.0))):
        centers.append(center)
        radii.append(1.0)
        rows.append(row)
    white, blue = (1.0, 1.0, 1.0), (0.5, 0.7, 1.0)
    env = dict(enabled=1.0, ground=white, horizon=white, zenith=blue,
               sun_focus=1.0, sun_intensity=0.0, sun_dir=(0.0, 1.0, 0.0))
    empty = np.zeros((0, 3, 3), np.float32)
    scene = _scene(np.stack([np.asarray(c, np.float32) for c in centers]),
                   radii, rows, empty, empty, [], env, [])
    cam = _look_at((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                   fov_y_deg=20.0, focus_distance=10.0,
                   defocus_strength=20.0, diverge_strength=1.0)
    return scene, cam


def json_scene(path):
    """A scene file of spheres and baked triangle groups (the Unity
    scenes' mirror format: ``settings``, ``environment``, ``spheres``,
    ``camera`` with a rotation matrix, ``meshes`` of ``npz`` groups) ->
    ``(RefScene, RefCamera, settings)``."""
    path = Path(path)
    spec = json.loads(path.read_text())

    def mat(d):
        d = d or {}
        flag = int(d.get("flag", 0))
        return _material(
            colour=tuple(d.get("colour", (1, 1, 1))),
            emission_colour=tuple(d.get("emissionColour", (1, 1, 1))),
            specular_colour=tuple(d.get("specularColour", (1, 1, 1))),
            emission_strength=float(d.get("emissionStrength", 0.0)),
            smoothness=float(d.get("smoothness", 0.0)),
            specular_probability=float(d.get("specularProbability", 1.0)),
            flag=flag, ior=float(d.get("ior", 1.5 if flag == 3 else 1.0)))

    centers, radii, sph_rows = [], [], []
    for s in spec.get("spheres", []):
        centers.append(np.asarray(s["position"], np.float32))
        radii.append(float(s["radius"]))
        sph_rows.append(mat(s.get("material")))
    tri_pos, tri_nrm, tri_rows, chunks = [], [], [], []
    first = 0
    npz = {}
    for m in spec.get("meshes", []):
        if "npz" not in m:
            raise ValueError("the reference reads baked npz groups only")
        f = path.parent / m["npz"]
        if f not in npz:
            npz[f] = np.load(f)
        pos = np.asarray(npz[f][m["group"] + "_pos"], np.float32)
        tri_pos.append(pos)
        tri_nrm.append(np.asarray(npz[f][m["group"] + "_nrm"], np.float32))
        tri_rows.append(mat(m.get("material")))
        chunks.append((first, len(pos)))
        first += len(pos)
    envd = spec.get("environment") or {}
    sun = np.asarray(envd.get("sunDirection", (0, 1, 0)), np.float32)
    sun = sun / max(np.linalg.norm(sun), 1e-20)
    env = dict(enabled=1.0 if envd.get("enabled") else 0.0,
               ground=envd.get("groundColour", (0, 0, 0)),
               horizon=envd.get("skyColourHorizon", (0, 0, 0)),
               zenith=envd.get("skyColourZenith", (0, 0, 0)),
               sun_focus=max(1.0, float(envd.get("sunFocus", 1))),
               sun_intensity=max(0.0, float(envd.get("sunIntensity", 0))),
               sun_dir=sun)
    scene = _scene(np.array(centers, np.float32).reshape(-1, 3), radii,
                   sph_rows, np.concatenate(tri_pos) if tri_pos else
                   np.zeros((0, 3, 3), np.float32),
                   np.concatenate(tri_nrm) if tri_nrm else
                   np.zeros((0, 3, 3), np.float32), tri_rows, env, chunks)
    camd = spec.get("camera") or {}
    cam = RefCamera(
        position=np.asarray(camd.get("position", (0, 0, -3)), np.float32),
        rotation=np.asarray(camd["rotation"], np.float32),
        fov_y_deg=float(camd.get("fovY", 60.0)),
        focus_distance=float(camd.get("focusDistance", 1.0)),
        defocus_strength=float(camd.get("defocusStrength", 0.0)),
        diverge_strength=float(camd.get("divergeStrength", 0.3)))
    return scene, cam, spec.get("settings") or {}


# ---------------------------------------------------------------- device


class Tracer:
    """A scene and camera on a device, in ``dtype``, ready to trace."""

    def __init__(self, scene: RefScene, cam: RefCamera, width: int,
                 height: int, max_bounce: int, spp: int, device,
                 dtype=torch.float32, clamp: bool = False):
        self.w, self.h, self.mb, self.spp = width, height, max_bounce, spp
        self.clamp = clamp  # the running average saturates each frame
        self.dev, self.dt = torch.device(device), dtype
        self.cpu = self.dev.type == "cpu"

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(
                self.dev, dtype)

        self.sph_c = f(scene.sph_center)
        self.sph_r = f(scene.sph_radius)
        self.sph_mat = torch.as_tensor(scene.sph_mat, device=self.dev)
        a = scene.tri_pos[:, 0]
        e_ab = scene.tri_pos[:, 1] - a
        e_ac = scene.tri_pos[:, 2] - a
        self.tri_a, self.tri_eab, self.tri_eac = f(a), f(e_ab), f(e_ac)
        self.tri_n = f(np.cross(e_ab, e_ac))
        self.tri_na, self.tri_nb, self.tri_nc = (
            f(scene.tri_nrm[:, i]) for i in range(3))
        self.tri_mat = torch.as_tensor(scene.tri_mat, device=self.dev)
        m = scene.materials
        self.mat = {k: (torch.as_tensor(v, device=self.dev) if k == "flag"
                        else f(v)) for k, v in m.items()}
        e = scene.env
        self.env = {k: f(e[k]) for k in ("ground", "horizon", "zenith",
                                          "sun_dir")}
        self.env_scalars = {k: f(e[k]) for k in ("enabled", "sun_focus",
                                                 "sun_intensity")}
        self.cam = {k: f(getattr(cam, k)) for k in (
            "position", "rotation", "fov_y_deg", "focus_distance",
            "defocus_strength", "diverge_strength")}
        self._count_tables(scene)

    # -- f32 transcendentals: on the CPU through float64 and rounded, as
    # correctly rounded as the card's library versions are close to it

    def _f64(self, fn, *args):
        if self.cpu:
            return fn(*(a.double() for a in args)).to(self.dt)
        return fn(*args)

    def sqrt(self, x):
        return self._f64(torch.sqrt, x)

    def rsqrt(self, x):
        return self._f64(torch.rsqrt, x)

    def cos(self, x):
        return self._f64(torch.cos, x)

    def sin(self, x):
        return self._f64(torch.sin, x)

    def log(self, x):
        return self._f64(torch.log, x)

    def pow(self, x, y):
        y = torch.as_tensor(y, dtype=self.dt, device=x.device)
        return self._f64(torch.pow, x, y.expand_as(x))

    def div(self, x, c):
        return x / torch.tensor(c, dtype=x.dtype, device=x.device)

    @staticmethod
    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    @staticmethod
    def cross(a, b):
        ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
        bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
        return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                            ax * by - ay * bx], dim=-1)

    def normalize(self, v):
        return v * self.rsqrt(self.dot(v, v))[..., None]

    def fmax(self, x, c):
        """IEEE maxNum, as the kernel's ``fmaxf``: a NaN operand drops."""
        return torch.fmax(x, torch.tensor(c, dtype=x.dtype, device=x.device))

    def fmin(self, x, c):
        return torch.fmin(x, torch.tensor(c, dtype=x.dtype, device=x.device))

    def smoothstep(self, lo, hi, x):
        t = self.fmin(self.fmax(self.div(x - lo, hi - lo), 0.0), 1.0)
        return t * t * (3.0 - 2.0 * t)

    # -- RNG

    @staticmethod
    def seed(pix, frame):
        return (pix.long() + (frame.long() & MASK) * FRAME_STRIDE) & MASK

    @staticmethod
    def next_random(state):
        state = (state * PCG_MUL + PCG_INC) & MASK
        shift = (state >> 28) + 4
        result = (((state >> shift) ^ state) * PCG_OUT) & MASK
        return state, (result >> 22) ^ result

    def random_value(self, state):
        state, bits = self.next_random(state)
        value = bits.to(torch.float32) * INV_U32_MAX
        return state, value.to(self.dt)

    def random_normal(self, state):
        state, r1 = self.random_value(state)
        state, r2 = self.random_value(state)
        theta = (2.0 * PI_BOXMULLER) * r1
        rho = self.sqrt(-2.0 * self.log(r2))
        return state, rho * self.cos(theta)

    def random_direction(self, state):
        state, x = self.random_normal(state)
        state, y = self.random_normal(state)
        state, z = self.random_normal(state)
        inv = self.rsqrt(x * x + y * y + z * z)
        return state, torch.stack([x * inv, y * inv, z * inv], dim=-1)

    def random_in_circle(self, state):
        state, r1 = self.random_value(state)
        angle = r1 * 2.0 * PI_LOWP
        state, r2 = self.random_value(state)
        radius = self.sqrt(r2)
        return state, torch.stack([self.cos(angle) * radius,
                                   self.sin(angle) * radius], dim=-1)

    # -- camera

    def focus_points(self, pix):
        c = self.cam
        x, y = pix % self.w, pix // self.w
        half_fov = c["fov_y_deg"] * float(np.float32(np.pi / 360.0))
        plane_h = c["focus_distance"] * torch.tan(half_fov) * 2.0
        plane_w = plane_h * float(np.float32(self.w / self.h))
        u = self.div(x.to(self.dt) + 0.5, float(self.w))
        v = self.div(y.to(self.dt) + 0.5, float(self.h))
        lx = (u - 0.5) * plane_w
        ly = (v - 0.5) * plane_h
        rot, focus = c["rotation"], c["focus_distance"]
        return torch.stack([c["position"][i] + (
            lx * rot[i, 0] + ly * rot[i, 1] + focus * rot[i, 2])
            for i in range(3)], dim=-1)

    def camera_rays(self, state, fp):
        c = self.cam
        right, up = c["rotation"][:, 0], c["rotation"][:, 1]
        inv_w = float(np.float32(1.0) / np.float32(self.w))
        state, defocus = self.random_in_circle(state)
        defocus = defocus * (c["defocus_strength"] * inv_w)
        origin = (c["position"][None, :] + right[None, :] * defocus[..., 0:1]
                  + up[None, :] * defocus[..., 1:2])
        state, jitter = self.random_in_circle(state)
        jitter = jitter * (c["diverge_strength"] * inv_w)
        target = (fp + right[None, :] * jitter[..., 0:1]
                  + up[None, :] * jitter[..., 1:2])
        return state, origin, self.normalize(target - origin)

    # -- closest hit

    def closest_hit(self, o, d, counts=None):
        """-> (t, index, hit): the nearest sphere (lower index on a tie),
        then a triangle if strictly nearer; index is a sphere's, or the
        sphere count plus a triangle's."""
        b = o.shape[0]
        s = self.sph_c.shape[0]
        best_t = torch.full((b,), INF, dtype=self.dt, device=self.dev)
        best = torch.zeros((b,), dtype=torch.int64, device=self.dev)
        if s:
            r = self.sph_r
            oc = o[:, None, :] - self.sph_c[None, :, :]
            bb = self.dot(oc, d[:, None, :])
            cc = self.dot(oc, oc) - (r * r)[None, :]
            disc = bb * bb - cc
            t = -bb - self.sqrt(self.fmax(disc, 0.0))
            valid = (disc >= 0.0) & (t >= 0.0) & (r > 0.0)[None, :]
            best_t, best = torch.min(torch.where(valid, t, INF), dim=1)
        if self.tri_a.shape[0]:
            ao = o[:, None, :] - self.tri_a[None, :, :]
            dao = self.cross(ao, d[:, None, :])
            det = -self.dot(d[:, None, :], self.tri_n[None, :, :])
            t_det = self.dot(ao, self.tri_n[None, :, :])
            u_det = self.dot(self.tri_eac[None, :, :], dao)
            v_det = -self.dot(self.tri_eab[None, :, :], dao)
            w_det = det - u_det - v_det
            ok = ((det >= DET_EPS) & (t_det >= 0.0) & (u_det >= 0.0)
                  & (v_det >= 0.0) & (w_det >= 0.0))
            t = t_det / torch.where(det >= DET_EPS, det, torch.ones_like(det))
            t_t, i_t = torch.min(torch.where(ok, t, INF), dim=1)
            nearer = t_t < best_t
            best_t = torch.where(nearer, t_t, best_t)
            best = torch.where(nearer, s + i_t, best)
        if counts is not None:
            counts["ops"] += float(self.ops_per_segment(o, d, best_t).sum())
            counts["segments"] += b
        return best_t, best, torch.isfinite(best_t)

    def hit_surface(self, o, d, t, best, hit):
        """-> (point, normal, material index) of each ray's winner."""
        s = self.sph_c.shape[0]
        point = o + d * torch.where(hit, t, 0.0)[:, None]
        is_sph = best < s
        normal = torch.zeros_like(point)
        mat = torch.zeros_like(best)
        if s:
            si = torch.clamp(best, max=s - 1)
            n_sph = self.normalize(point - self.sph_c[si])
            normal = n_sph
            mat = self.sph_mat[si]
        if self.tri_a.shape[0]:
            ti = torch.clamp(best - s, 0, self.tri_a.shape[0] - 1)
            ao = o - self.tri_a[ti]
            dao = self.cross(ao, d)
            det = -self.dot(d, self.tri_n[ti])
            inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
            u = self.dot(self.tri_eac[ti], dao) * inv_det
            v = -self.dot(self.tri_eab[ti], dao) * inv_det
            w = 1.0 - u - v
            raw = (self.tri_na[ti] * w[:, None] + self.tri_nb[ti] * u[:, None]
                   + self.tri_nc[ti] * v[:, None])
            normal = torch.where(is_sph[:, None], normal, self.normalize(raw))
            mat = torch.where(is_sph, mat, self.tri_mat[ti])
        return point, normal, torch.where(hit, mat, 0)

    # -- the least work of a closest hit

    def _count_tables(self, scene: RefScene) -> None:
        """Boxes of the counted scan, in two levels: spheres past four
        times the median radius are hoisted (tested by every ray); the
        rest are cut into clusters of ``GROUP`` in the order of their
        centres' Morton codes, and each triangle group is a chunk; runs of
        ``GROUP`` boxes in the same order of their centres sit under a
        super box."""
        r = scene.sph_radius
        real = np.nonzero(r > 0)[0]
        big = r[real] > 4.0 * np.median(r[real]) if len(real) else real
        self.n_hoist = int(big.sum()) if len(real) else 0
        rest = real[~big] if len(real) else real
        lo_hi, ops = [], []
        if len(rest):
            c = scene.sph_center[rest]
            rest = rest[_morton_order(c)]
            for i in range(0, len(rest), GROUP):
                m = rest[i:i + GROUP]
                rr = scene.sph_radius[m][:, None]
                lo_hi.append(np.concatenate([(scene.sph_center[m] - rr).min(0),
                                             (scene.sph_center[m] + rr).max(0)]))
                ops.append(OPS_SPHERE * len(m))
        for first, count in scene.chunks:
            p = scene.tri_pos[first:first + count].reshape(-1, 3)
            lo_hi.append(np.concatenate([p.min(0), p.max(0)]))
            ops.append(OPS_TRIANGLE * count)
        boxes = np.array(lo_hi, np.float32).reshape(-1, 6)
        order = _morton_order((boxes[:, :3] + boxes[:, 3:]) / 2)
        boxes, ops = boxes[order], np.array(ops, np.float64)[order]
        supers = [np.concatenate([boxes[i:i + GROUP, :3].min(0),
                                  boxes[i:i + GROUP, 3:].max(0)])
                  for i in range(0, len(boxes), GROUP)]
        self.box = torch.tensor(boxes, device=self.dev)
        self.box_ops = torch.tensor(ops, device=self.dev)
        self.box_super = torch.arange(len(boxes), device=self.dev) // GROUP
        self.supers = torch.tensor(np.array(supers, np.float32).reshape(-1, 6),
                                   device=self.dev)
        self.super_boxes = torch.bincount(self.box_super).double()

    def _entered(self, o, inv, boxes, bound):
        t0 = (boxes[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
        t1 = (boxes[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
        free = torch.isnan(t0) | torch.isnan(t1)
        near = torch.where(free, -INF, torch.minimum(t0, t1)).amax(-1)
        far = torch.where(free, INF, torch.maximum(t0, t1)).amin(-1)
        return (near <= far) & (far >= 0.0) & (near <= bound[:, None])

    def ops_per_segment(self, o, d, best_t):
        """FP32 operations a segment's closest hit needs under an exact
        scan gated by boxes with the final distance as bound: every
        hoisted sphere and super box tested, the boxes under each super box
        the segment enters, and the primitives of each of those boxes
        whose slab interval meets [0, t]."""
        base = float(OPS_SPHERE * self.n_hoist)
        n = o.shape[0]
        if not self.box.shape[0]:
            return torch.full((n,), base, device=self.dev,
                              dtype=torch.float64)
        o32, bound = o.float(), best_t.float()
        inv = 1.0 / d.float()
        sup = self._entered(o32, inv, self.supers, bound)
        inner = self._entered(o32, inv, self.box, bound) & sup[:, self.box_super]
        return (base + OPS_BOX * self.supers.shape[0]
                + OPS_BOX * (sup.double() * self.super_boxes[None, :]).sum(1)
                + (inner.double() * self.box_ops[None, :]).sum(1))

    # -- shading

    def environment(self, d):
        e, k = self.env, self.env_scalars
        dy = d[..., 1]
        sky_t = self.pow(self.smoothstep(0.0, 0.4, dy), 0.35)
        ground_t = self.smoothstep(-0.01, 0.0, dy)
        sky = e["horizon"][None, :] + sky_t[..., None] * (
            e["zenith"][None, :] - e["horizon"][None, :])
        sun = self.pow(self.fmax(self.dot(d, e["sun_dir"][None, :]), 0.0),
                       k["sun_focus"]) * k["sun_intensity"]
        comp = e["ground"][None, :] + ground_t[..., None] * (
            sky - e["ground"][None, :])
        comp = comp + (sun * (ground_t >= 1.0))[..., None]
        return comp * k["enabled"]

    def _refract(self, d, normal, ior, u):
        entering = self.dot(d, normal) < 0.0
        n_eff = torch.where(entering[..., None], normal, -normal)
        eta = torch.where(entering, 1.0 / ior, ior)
        cos_t = self.fmin(-self.dot(d, n_eff), 1.0)
        sin_t = self.sqrt(self.fmax(1.0 - cos_t * cos_t, 0.0))
        cannot = eta * sin_t > 1.0
        r0 = (1.0 - eta) / (1.0 + eta)
        r0 = r0 * r0
        schlick = r0 + (1.0 - r0) * self.pow(1.0 - cos_t, 5.0)
        reflect = cannot | (schlick > u)
        r_perp = eta[..., None] * (d + cos_t[..., None] * n_eff)
        k = self.fmax(1.0 - self.dot(r_perp, r_perp), 0.0)
        refracted = r_perp - self.sqrt(k)[..., None] * n_eff
        reflected = d - (2.0 * self.dot(d, n_eff))[..., None] * n_eff
        return torch.where(reflect[..., None], reflected, refracted)

    def segment(self, state, o, d, incoming, colour, bounce, counts=None):
        """One bounce of live lanes -> (state, o, d, incoming, colour,
        continues)."""
        t, best, hit = self.closest_hit(o, d, counts)
        point, normal, mi = self.hit_surface(o, d, t, best, hit)
        m = {k: v[mi] for k, v in self.mat.items()}
        fx, fz = torch.floor(point[..., 0]), torch.floor(point[..., 2])
        cx = fx - 2.0 * torch.floor(self.div(fx, 2.0))
        cz = fz - 2.0 * torch.floor(self.div(fz, 2.0))
        swap = (m["flag"] == FLAG_CHECKER) & (cx != cz)
        base = torch.where(swap[..., None], m["emission_colour"], m["colour"])
        passthru = hit & (m["flag"] == FLAG_INVISIBLE_LIGHT) & (bounce == 0)
        scattering = hit & ~passthru

        new_state, u_spec = self.random_value(state)
        is_spec = (m["specular_probability"] >= u_spec).to(self.dt)
        new_state, unit = self.random_direction(new_state)
        diffuse = self.normalize(normal + unit)
        specular = d - (2.0 * self.dot(d, normal))[..., None] * normal
        surface = self.normalize(diffuse + (m["smoothness"] * is_spec)[
            ..., None] * (specular - diffuse))
        dielectric = m["flag"] == FLAG_DIELECTRIC
        glass = self._refract(d, normal, m["ior"], u_spec)
        new_d = torch.where(dielectric[..., None], glass, surface)
        new_o = point + torch.where(dielectric[..., None],
                                    new_d * DIELECTRIC_EPS, 0.0)
        is_spec = torch.where(dielectric, 0.0, is_spec)

        emitted = m["emission_colour"] * m["emission_strength"][..., None]
        inc_hit = incoming + emitted * colour
        col_hit = colour * (base + is_spec[..., None] * (
            m["specular_colour"] - base))
        p = torch.fmax(torch.fmax(col_hit[..., 0], col_hit[..., 1]),
                       col_hit[..., 2])
        new_state, u_rr = self.random_value(new_state)
        survive = u_rr < p
        col_boost = col_hit * (1.0 / self.fmax(p, 1e-30))[..., None]
        inc_miss = incoming + self.environment(d) * colour

        sc3 = scattering[..., None]
        o = torch.where(passthru[..., None], point + d * PASSTHROUGH_EPS,
                        torch.where(sc3, new_o, o))
        d = torch.where(sc3, new_d, d)
        incoming = torch.where(sc3, inc_hit, torch.where(
            (~hit)[..., None], inc_miss, incoming))
        colour = torch.where(sc3 & survive[..., None], col_boost, colour)
        state = torch.where(scattering, new_state, state)
        return state, o, d, incoming, colour, passthru | (scattering & survive)

    # -- lanes

    def render_lanes(self, pix, frame, block: int, counts=None):
        """Each lane's frame mean and segments: lane i traces pixel
        ``pix[i]`` of frame ``frame[i]``, ``spp`` samples from one stream
        -> ``(mean (L, 3), segments (L,) int64)``. At most ``block`` lanes
        trace a segment in one call. ``counts``, a dict with ``ops`` and
        ``segments``, gains the least work of each segment traced."""
        n = pix.shape[0]
        dev, dt = self.dev, self.dt
        pix = pix.to(dev)
        fp = self.focus_points(pix)
        state = self.seed(pix, frame.to(dev))
        o = torch.zeros((n, 3), dtype=dt, device=dev)
        d = torch.zeros_like(o)
        colour, incoming, total = torch.zeros_like(o), torch.zeros_like(o), \
            torch.zeros_like(o)
        bounce = torch.zeros(n, dtype=torch.int64, device=dev)
        done = torch.zeros(n, dtype=torch.int64, device=dev)
        segs = torch.zeros(n, dtype=torch.int64, device=dev)
        live = torch.zeros(n, dtype=torch.bool, device=dev)
        while True:
            start = (~live & (done < self.spp)).nonzero().squeeze(1)
            if start.numel():
                st, o_s, d_s = self.camera_rays(state[start], fp[start])
                state[start], o[start], d[start] = st, o_s, d_s
                colour[start] = 1.0
                incoming[start] = 0.0
                bounce[start] = 0
                live[start] = True
            lanes = live.nonzero().squeeze(1)
            if not lanes.numel():
                break
            segs[lanes] += 1
            for c0 in range(0, lanes.numel(), block):
                i = lanes[c0:c0 + block]
                st, o_i, d_i, inc_i, col_i, cont = self.segment(
                    state[i], o[i], d[i], incoming[i], colour[i], bounce[i],
                    counts)
                cont = cont & (bounce[i] < self.mb)
                died = i[~cont]
                state[i], o[i], d[i], colour[i] = st, o_i, d_i, col_i
                total[died] += inc_i[~cont]
                done[died] += 1
                incoming[i] = torch.where(cont[:, None], inc_i, 0.0)
                live[i] = cont
                bounce[i] += 1
        return self.div(total, float(self.spp)), segs


def _morton_order(points: np.ndarray) -> np.ndarray:
    """Indices of ``points`` (N, 3) in the order of their 30-bit Morton
    codes over their bounds, ties in index order."""
    p = points.astype(np.float64)
    lo, hi = p.min(0), p.max(0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)
    code = np.zeros(len(p), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return np.argsort(code, kind="stable")


def fold(frames, means: np.ndarray, prev: np.ndarray, clamp: bool):
    """The running average over ``frames`` (ascending) of ``means`` (F, P,
    3) f32 into ``prev`` (P, 3): ``prev * (1 - w) + cur * w`` with ``w =
    1 / (frame + 1)`` in f32, saturated each step when ``clamp``."""
    acc = np.asarray(prev, np.float32).copy()
    one = np.float32(1.0)
    for f, cur in zip(frames, means):
        w = one / (np.float32(f) + one)
        acc = acc * (one - w) + cur.astype(np.float32) * w
        if clamp:  # the kernel's fminf / fmaxf: NaN saturates to 0
            acc = np.fmin(np.fmax(acc, np.float32(0.0)), np.float32(1.0))
    return acc
