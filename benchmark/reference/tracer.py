"""The reference path tracer: one path a (pixel, iteration, camera), traced
as a batch of independent lanes, every float in `dtype`.

A path starts at the camera (Gaussian anti-aliasing jitter of sigma 0.005
pixels, a thin lens where the lens radius is positive), and at each of
`depth` bounces finds its closest hit over the scene's boxes, spheres and
triangles, in that order, a later hit replacing an earlier one only when
strictly closer. A miss ends the path black, a light ends it with its
throughput times the light's colour and emittance, and any other surface
scatters it: diffuse (cosine-weighted), glossy (a luminance-weighted pick
of diffuse or mirror), or refractive (Schlick's Fresnel pick of mirror or
refraction). A path that is still scattering after its last bounce
contributes nothing.

The triangles are tested by brute force (Moller-Trumbore, t >= 1e-6),
cluster by cluster: a cluster's triangles are tested for the rays that
meet its padded bounding box nearer than their closest hit so far, which
leaves the closest hit exactly what testing every triangle would give.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import rng

SCATTER_EPS = 1e-3
TRI_EPS = 1e-6
SQRT_1_3 = 0.5773502691896257645091487805019574556476
LUMA = (0.2126, 0.7152, 0.0722)
CLUSTER = 256          # triangles a cluster
RAY_BLOCK = 1 << 15    # rays a block of a cluster's test


class V(tuple):
    """A 3-vector of equally shaped tensors."""

    def __new__(cls, x, y, z):
        return tuple.__new__(cls, (x, y, z))

    def __add__(self, o):
        return V(*(a + b for a, b in zip(self, o)))

    def __sub__(self, o):
        return V(*(a - b for a, b in zip(self, o)))

    def __mul__(self, s):
        if isinstance(s, V):
            return V(*(a * b for a, b in zip(self, s)))
        return V(*(a * s for a in self))

    def __neg__(self):
        return V(*(-a for a in self))

    def dot(self, o):
        return self[0] * o[0] + self[1] * o[1] + self[2] * o[2]

    def cross(self, o):
        return V(self[1] * o[2] - self[2] * o[1],
                 self[2] * o[0] - self[0] * o[2],
                 self[0] * o[1] - self[1] * o[0])

    def normalize(self):
        return self * torch.rsqrt(torch.clamp(self.dot(self), min=1e-30))

    def index(self, i):
        return V(*(a[i] for a in self))

    @staticmethod
    def where(c, a, b):
        return V(*(torch.where(c, x, y) for x, y in zip(a, b)))


def _clusters(centroid: np.ndarray, size: int) -> list:
    """Triangle indices split at the median of the centroids' widest axis
    until each part has at most `size`."""
    out, todo = [], [np.arange(centroid.shape[0])]
    while todo:
        idx = todo.pop()
        if len(idx) <= size:
            out.append(idx)
            continue
        c = centroid[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        idx = idx[np.argsort(c[:, axis], kind="stable")]
        half = len(idx) // 2
        todo += [idx[half:], idx[:half]]
    return out


class Tables:
    """A parsed Scene on `device`, every float in `dtype`."""

    def __init__(self, scene, device, dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        self.width, self.height, self.depth = (scene.width, scene.height,
                                               scene.depth)

        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device).to(dtype)

        mats = scene.materials
        self.color = f([m["color"] for m in mats])
        self.spec = f([m["specular_color"] for m in mats])
        self.refl = f([m["has_reflective"] for m in mats])
        self.refr = f([m["has_refractive"] for m in mats])
        self.ior = f([m["ior"] for m in mats])
        self.emit = f([m["emittance"] for m in mats])
        self.geoms = [(kind, mat, f(inv), f(inv_t))
                      for kind, mat, inv, inv_t in scene.geoms]
        self.pixel_length = f(scene.pixel_length)
        self.focal, self.lens = f(scene.focal), float(scene.lens)
        self.tris = None
        if scene.tris is not None:
            t = scene.tris
            parts = _clusters((t["v0"].astype(np.float64) + t["v1"]
                               + t["v2"]) / 3.0, CLUSTER)
            order = np.concatenate(parts)
            v = np.stack([t["v0"], t["v1"], t["v2"]], 1)[order]
            pad = 1e-4 * (1.0 + float(np.abs(v).max()))
            self.bounds, start = [], 0
            for p in parts:
                blk = v[start:start + len(p)].reshape(-1, 3)
                self.bounds.append((start, start + len(p),
                                    f(blk.min(0) - pad), f(blk.max(0) + pad)))
                start += len(p)
            v0, v1, v2 = (t[k][order] for k in ("v0", "v1", "v2"))
            self.tris = {"v0": f(v0), "e1": f(v1) - f(v0),
                         "e2": f(v2) - f(v0),
                         "n0": f(t["n0"][order]), "n1": f(t["n1"][order]),
                         "n2": f(t["n2"][order]),
                         "mat": torch.as_tensor(t["mat"][order].astype(
                             np.int64), device=self.device)}


def _apply(m, v: V, w: float) -> V:
    """(m @ [v, w]).xyz for a 4x4 matrix tensor."""
    return V(*(m[r, 0] * v[0] + m[r, 1] * v[1] + m[r, 2] * v[2]
               + m[r, 3] * w for r in range(3)))


def _box(inv, inv_t, o: V, d: V):
    """The unit cube (side 1, centred) in object space: (t, normal), t = -1
    on a miss; from inside, the exit."""
    qo, qd = _apply(inv, o, 1.0), _apply(inv, d, 0.0)
    big = torch.finfo(qo[0].dtype).max
    tmin = torch.full_like(qo[0], -big)
    tmax = torch.full_like(qo[0], big)
    zero = torch.zeros_like(qo[0])
    nmin, nmax = [zero] * 3, [zero] * 3
    for ax in range(3):
        dc = qd[ax]
        dc = torch.where(torch.abs(dc) < 1e-20,
                         torch.where(dc < 0, -1e-20, 1e-20).to(dc.dtype), dc)
        t1 = (-0.5 - qo[ax]) / dc
        t2 = (0.5 - qo[ax]) / dc
        near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
        sign = torch.where(t2 < t1, 1.0, -1.0).to(dc.dtype)
        axis_n = [sign * float(c == ax) for c in range(3)]
        closer = (near > 0.0) & (near > tmin)
        tmin = torch.where(closer, near, tmin)
        nmin = [torch.where(closer, axis_n[c], nmin[c]) for c in range(3)]
        nearer = far < tmax
        tmax = torch.where(nearer, far, tmax)
        nmax = [torch.where(nearer, axis_n[c], nmax[c]) for c in range(3)]
    hit = (tmax >= tmin) & (tmax > 0.0)
    inside = tmin <= 0.0
    t = torch.where(inside, tmax, tmin)
    n = V.where(inside, V(*nmax), V(*nmin))
    return torch.where(hit, t, -1.0), _apply(inv_t, n, 0.0).normalize()


def _sphere(inv, inv_t, o: V, d: V):
    """The sphere of radius 0.5 in object space: (t, normal facing out of
    the surface the ray meets), t = -1 on a miss."""
    ro, rd = _apply(inv, o, 1.0), _apply(inv, d, 0.0)
    a = rd.dot(rd)
    b = ro.dot(rd)
    c = ro.dot(ro) - 0.25
    disc = b * b - a * c
    real = disc >= 0.0
    root = torch.sqrt(torch.where(real, torch.clamp(disc, min=0.0),
                                  torch.ones_like(disc)))
    inv_a = 1.0 / a
    t1 = (-b + root) * inv_a
    t2 = (-b - root) * inv_a
    behind = (t1 < 0.0) & (t2 < 0.0)
    ahead = (t1 > 0.0) & (t2 > 0.0)
    t = torch.where(ahead, torch.minimum(t1, t2), torch.maximum(t1, t2))
    n = _apply(inv_t, ro + rd * t, 0.0).normalize()
    n = n * torch.where(ahead, 1.0, -1.0).to(t.dtype)
    return torch.where(real & ~behind, t, -1.0), n


def _triangles(tb: Tables, o: V, d: V, t_best):
    """The closest triangle hit nearer than `t_best` [R]: (t, u, v, index),
    index -1 where none is."""
    tri = tb.tris
    r = o[0].shape[0]
    best_t = t_best.clone()
    best_i = torch.full((r,), -1, dtype=torch.int64, device=tb.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    inv = V(*(1.0 / torch.where(torch.abs(c) < 1e-20, torch.where(
        c < 0, -1e-20, 1e-20).to(c.dtype), c) for c in d))
    for lo, hi, bmin, bmax in tb.bounds:
        t0 = [(bmin[a] - o[a]) * inv[a] for a in range(3)]
        t1 = [(bmax[a] - o[a]) * inv[a] for a in range(3)]
        near = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                           torch.minimum(t0[1], t1[1])),
                             torch.minimum(t0[2], t1[2]))
        far = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                          torch.maximum(t0[1], t1[1])),
                            torch.maximum(t0[2], t1[2]))
        rows = torch.nonzero((far >= torch.clamp(near, min=0.0))
                             & (near <= best_t))[:, 0]
        for k in range(0, rows.shape[0], RAY_BLOCK):
            rk = rows[k:k + RAY_BLOCK]
            ro = V(*(c[rk, None] for c in o))
            rd = V(*(c[rk, None] for c in d))
            v0 = V(*(tri["v0"][None, lo:hi, c] for c in range(3)))
            e1 = V(*(tri["e1"][None, lo:hi, c] for c in range(3)))
            e2 = V(*(tri["e2"][None, lo:hi, c] for c in range(3)))
            h = rd.cross(e2)
            a = e1.dot(h)
            flat = torch.abs(a) < TRI_EPS
            f = 1.0 / torch.where(flat, torch.ones_like(a), a)
            s = ro - v0
            u = f * s.dot(h)
            q = s.cross(e1)
            v = f * rd.dot(q)
            t = f * e2.dot(q)
            ok = (~flat & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t >= TRI_EPS)
                  & (t < best_t[rk, None]))
            t = torch.where(ok, t, torch.full_like(t, math.inf))
            tk, j = t.min(dim=1)
            won = tk < best_t[rk]
            w = rk[won]
            jw = j[won, None]
            best_t[w] = tk[won]
            best_i[w] = lo + j[won]
            best_u[w] = u[won].gather(1, jw)[:, 0]
            best_v[w] = v[won].gather(1, jw)[:, 0]
    return best_t, best_u, best_v, best_i


def closest_hit(tb: Tables, o: V, d: V, live):
    """(t, normal, material) of the closest hit of each ray, t = -1 on a
    miss: boxes and spheres in scene order, then the triangles of the rays
    that are `live`."""
    n = o[0].shape[0]
    t_best = torch.full((n,), torch.finfo(tb.dtype).max, dtype=tb.dtype,
                        device=tb.device)
    n_best = V(*(torch.zeros_like(t_best) for _ in range(3)))
    m_best = torch.zeros(n, dtype=torch.int64, device=tb.device)
    hit = torch.zeros(n, dtype=torch.bool, device=tb.device)
    for kind, mat, inv, inv_t in tb.geoms:
        t, nrm = (_sphere if kind == "sphere" else _box)(inv, inv_t, o, d)
        better = (t > 0.0) & (t < t_best)
        t_best = torch.where(better, t, t_best)
        n_best = V.where(better, nrm, n_best)
        m_best = torch.where(better, mat, m_best)
        hit = hit | better
    if tb.tris is not None:
        rows = torch.nonzero(live)[:, 0]
        ro, rd = o.index(rows), d.index(rows)
        t, u, v, i = _triangles(tb, ro, rd, t_best[rows])
        won = i >= 0
        ic = torch.clamp(i, min=0)
        w = 1.0 - u - v
        tri = tb.tris
        corner = [V(*(tri[k][ic, c] for c in range(3)))
                  for k in ("n0", "n1", "n2")]
        nrm = (corner[0] * w + corner[1] * u + corner[2] * v).normalize()
        nrm = nrm * torch.where(rd.dot(nrm) > 0.0, -1.0, 1.0).to(t.dtype)
        t_best[rows] = torch.where(won, t, t_best[rows])
        for c in range(3):
            n_best[c][rows] = torch.where(won, nrm[c], n_best[c][rows])
        m_best[rows] = torch.where(won, tri["mat"][ic], m_best[rows])
        hit[rows] = hit[rows] | won
    return torch.where(hit, t_best, -1.0), n_best, m_best


def _hemisphere(n: V, u1, u2) -> V:
    """A cosine-weighted direction about `n`."""
    up = torch.sqrt(u1)
    over = torch.sqrt(torch.clamp(1.0 - up * up, min=0.0))
    around = u2 * (2.0 * math.pi)
    one, zero = torch.ones_like(u1), torch.zeros_like(u1)
    ax = torch.abs(n[0]) < SQRT_1_3
    ay = torch.abs(n[1]) < SQRT_1_3
    other = V(torch.where(ax, one, zero),
              torch.where(ax, zero, torch.where(ay, one, zero)),
              torch.where(ax | ay, zero, one))
    p1 = n.cross(other).normalize()
    p2 = n.cross(p1).normalize()
    return (n * up + p1 * (torch.cos(around) * over)
            + p2 * (torch.sin(around) * over))


def _reflect(i: V, n: V) -> V:
    return i - n * (2.0 * i.dot(n))


def _pick_weight(first, p):
    """The value of the renderer's branch weight: p / p for the branch
    taken (1, unless its probability is below 1e-6)."""
    return torch.where(first, p / torch.clamp(p, min=1e-6),
                       (1.0 - p) / torch.clamp(1.0 - p, min=1e-6))


def _scatter(tb: Tables, d: V, hit_p: V, n: V, mat, u):
    """(origin, direction, throughput) of the scattered ray."""
    color = V(*(tb.color[mat, c] for c in range(3)))
    spec = V(*(tb.spec[mat, c] for c in range(3)))
    refl, refr = tb.refl[mat], tb.refr[mat]
    diffuse = _hemisphere(n, u[1], u[2])
    origin, direction, thr = hit_p + n * SCATTER_EPS, diffuse, color

    glossy = (refl != 0.0) & (refr == 0.0)
    luma = lambda c: c[0] * LUMA[0] + c[1] * LUMA[1] + c[2] * LUMA[2]
    rough = 1.0 - refl
    dl = luma(color) * (rough + 0.2)
    sl = luma(spec) * (1.0 - rough)
    p_diff = dl / (dl + sl + 1e-6)
    take_diff = u[0] < p_diff
    g_dir = V.where(take_diff, diffuse, _reflect(d, n).normalize())
    g_thr = V.where(take_diff, color, spec) * _pick_weight(take_diff, p_diff)
    direction = V.where(glossy, g_dir, direction)
    thr = V.where(glossy, g_thr, thr)

    glass = refr != 0.0
    cos0 = -d.dot(n)
    entering = cos0 > 0.0
    rn = n * torch.where(entering, 1.0, -1.0).to(cos0.dtype)
    cos_i = torch.abs(cos0)
    ior = torch.where(tb.ior[mat] > 0.0, tb.ior[mat],
                      torch.ones_like(cos0))
    n_from = torch.where(entering, torch.ones_like(ior), ior)
    n_to = torch.where(entering, ior, torch.ones_like(ior))
    eta = n_from / n_to
    r0 = (n_from - n_to) / (n_from + n_to)
    r0 = r0 * r0
    m = torch.clamp(1.0 - cos_i, min=0.0)
    fresnel = r0 + (1.0 - r0) * (m * m * m * m * m)
    ci = -d.dot(rn)
    k = 1.0 - eta * eta * (1.0 - ci * ci)
    tir = k < 1e-6
    through = d * eta + rn * (eta * ci - torch.sqrt(torch.where(
        tir, torch.ones_like(k), k)))
    mirror = tir | (u[3] < fresnel)
    r_dir = V.where(mirror, _reflect(d, rn).normalize(),
                    V.where(tir, rn, through).normalize())
    r_org = V.where(mirror, hit_p + rn * SCATTER_EPS,
                    hit_p - rn * SCATTER_EPS)
    r_thr = V.where(mirror, spec, color) * torch.where(
        tir, torch.ones_like(k), _pick_weight(mirror, fresnel))
    return (V.where(glass, r_org, origin), V.where(glass, r_dir, direction),
            V.where(glass, r_thr, thr))


def _camera_rays(tb: Tables, cams: dict, cam_idx, pixel, key):
    """Primary rays of the paths: `cams` holds [C, 3] tensors, `cam_idx`
    and `pixel` [B], key(d) the paths' keys at depth d."""
    dt = tb.dtype
    j0, j1 = rng.normals(rng.pixel_state(key(-1), pixel), dt)
    x = (pixel % tb.width).to(dt) + torch.clamp(j0 * 0.005, -0.5, 0.5)
    y = (pixel // tb.width).to(dt) + torch.clamp(j1 * 0.005, -0.5, 0.5)
    cam = {k: V(*(cams[k][cam_idx, c] for c in range(3)))
           for k in ("position", "view", "right", "up")}
    sx = tb.pixel_length[0] * (x - 0.5 * tb.width)
    sy = tb.pixel_length[1] * (y - 0.5 * tb.height)
    d = (cam["view"] - cam["right"] * sx - cam["up"] * sy).normalize()
    o = cam["position"]
    if tb.lens > 0.0:
        u1, u2 = rng.uniforms(rng.pixel_state(key(-2), pixel), 2, dt)
        cos_v = d.dot(cam["view"])
        tiny = torch.where(cos_v >= 0.0, 1e-6, -1e-6).to(dt)
        cos_v = torch.where(torch.abs(cos_v) < 1e-6, tiny, cos_v)
        focus = o + d * (tb.focal / cos_v)
        sx2, sy2 = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
        use_x = torch.abs(sx2) > torch.abs(sy2)
        r = torch.where(use_x, sx2, sy2)
        theta = torch.where(
            use_x,
            (math.pi / 4.0) * (sy2 / torch.where(sx2 == 0.0, 1.0, sx2)),
            (math.pi / 2.0) - (math.pi / 4.0) * (
                sx2 / torch.where(sy2 == 0.0, 1.0, sy2)))
        r = torch.where((sx2 == 0.0) & (sy2 == 0.0), 0.0, r)
        lx = r * torch.cos(theta) * tb.lens
        ly = r * torch.sin(theta) * tb.lens
        o = o + cam["right"] * lx + cam["up"] * ly
        d = (focus - o).normalize()
    return o, d


def trace(tb: Tables, cams: dict, cam_idx, pixel, keys, it_idx):
    """[B, 3] radiance of the paths (pixel, iteration row `it_idx` of the
    key table `keys`, camera `cam_idx`)."""
    dt = tb.dtype

    def key(depth):
        return keys[it_idx, depth + 2]

    o, d = _camera_rays(tb, cams, cam_idx, pixel, key)
    b = pixel.shape[0]
    one = torch.ones(b, dtype=dt, device=tb.device)
    color = V(one, one, one)
    out = torch.zeros((b, 3), dtype=dt, device=tb.device)
    bounces = torch.full((b,), tb.depth, dtype=torch.int32,
                         device=tb.device)
    for depth in range(tb.depth):
        live = bounces > 0
        t, n, mat = closest_hit(tb, o, d, live)
        u = rng.uniforms(rng.pixel_state(key(depth), pixel), 4, dt)
        hit = t > 0.0
        emit = tb.emit[mat]
        light = hit & (emit > 0.0)
        scatter = live & hit & ~light
        hit_p = o + d * t
        s_org, s_dir, s_thr = _scatter(tb, d, hit_p, n, mat, u)
        o = V.where(scatter, s_org, o)
        d = V.where(scatter, s_dir, d)
        new = V.where(scatter, color * s_thr, color)
        mcol = V(*(tb.color[mat, c] for c in range(3)))
        new = V.where(live & light, color * mcol * emit, new)
        zero = torch.zeros_like(t)
        color = V.where(live & ~hit, V(zero, zero, zero), new)
        left = torch.where(scatter, bounces - 1, bounces)
        left = torch.where(scatter & (left == 0), -2, left)
        bounces = torch.where(live & (light | ~hit), 0, left)
        done = bounces == 0
        out = out + torch.where(done[:, None], torch.stack(color, 1),
                                torch.zeros_like(out))
        bounces = torch.where(done, -1, bounces)
    return out


def radiance(tb: Tables, cams: dict, cam_idx, pixel, iteration,
             seed: int, batch: int = 1 << 20) -> torch.Tensor:
    """[B, 3] radiance of the paths (pixel [B], iteration [B], camera
    index [B]; numpy or tensors), traced in batches of `batch`."""
    pixel = torch.as_tensor(np.asarray(pixel), dtype=torch.int64,
                            device=tb.device)
    iteration = np.asarray(iteration, np.int64)
    cam_idx = torch.as_tensor(np.asarray(cam_idx), dtype=torch.int64,
                              device=tb.device)
    its, it_idx = np.unique(iteration, return_inverse=True)
    keys = rng.key_table(seed, its.tolist(), tb.depth, tb.device)
    it_idx = torch.as_tensor(it_idx.reshape(-1), device=tb.device)
    cams = {k: torch.as_tensor(np.asarray(v, np.float32),
                               device=tb.device).to(tb.dtype)
            for k, v in cams.items()}
    out = [trace(tb, cams, cam_idx[s:s + batch], pixel[s:s + batch], keys,
                 it_idx[s:s + batch])
           for s in range(0, pixel.shape[0], batch)]
    return torch.cat(out) if out else torch.zeros((0, 3), dtype=tb.dtype)
