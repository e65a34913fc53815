"""The scene as the reference reads it: the scene JSON (materials, camera,
objects), its OBJ meshes and their MTL files, parsed here again, with the
transforms, the triangle table and the camera worked out in float64 and
stored in float32, as the renderer stores them.

Semantics (the reference CUDA tracer's scene.cpp / utilities.cpp /
main.cpp): an object's transform is T * Rx * Ry * Rz * S (degrees); a
mesh is baked to world space at load (normals by the inverse transpose,
winding flipped under a negative determinant, the face normal where the
OBJ has none, faces fanned into triangles); MTL materials follow the
scene's own, in file order; the app rebuilds its camera from spherical
coordinates at start-up, with `right` and `up` left unnormalized."""
from __future__ import annotations

import json
import math
import os

import numpy as np

DIFFUSE_GREY = {"color": (0.5, 0.5, 0.5), "specular_color": (0.0, 0.0, 0.0),
                "has_reflective": 0.0, "has_refractive": 0.0, "ior": 0.0,
                "emittance": 0.0}


def _material(p: dict) -> dict:
    """A scene JSON material: its colour and the BSDF's parameters."""
    m = dict(DIFFUSE_GREY)
    rgb = tuple(float(x) for x in p["RGB"])
    m["color"] = rgb
    kind = p["TYPE"]
    if kind == "Emitting":
        m["emittance"] = float(p["EMITTANCE"])
    elif kind == "Specular":
        m["has_reflective"] = 1.0 - min(max(float(p.get("ROUGHNESS", 0.0)),
                                            0.0), 1.0)
        m["specular_color"] = tuple(float(x) for x in
                                    p.get("SPECULAR_COLOR", rgb))
    elif kind == "Refractive":
        m["has_refractive"] = 1.0 - min(max(float(
            p.get("TRANSPARENCY", 0.0)), 0.0), 1.0)
        m["ior"] = float(p.get("IOR", 1.5))
        m["has_reflective"] = 1.0 - min(max(float(p.get("ROUGHNESS", 0.0)),
                                            0.0), 1.0)
        m["specular_color"] = tuple(float(x) for x in
                                    p.get("SPECULAR_COLOR", rgb))
    elif kind != "Diffuse":
        raise ValueError(f"unknown material type {kind!r}")
    return m


def _mtl(path: str) -> list:
    """An MTL file's materials, in file order, as (name, BSDF parameters)."""
    out, cur = [], None
    if not os.path.exists(path):
        return out
    with open(path, errors="replace") as f:
        for line in f:
            w = line.split()
            if not w or w[0].startswith("#"):
                continue
            if w[0] == "newmtl":
                cur = {"Kd": (0.6, 0.6, 0.6), "Ks": (0.0, 0.0, 0.0),
                       "Ke": (0.0, 0.0, 0.0), "Ni": 1.0,
                       "name": w[1] if len(w) > 1 else ""}
                out.append(cur)
            elif cur is not None and w[0] in ("Kd", "Ks", "Ke"):
                cur[w[0]] = tuple(float(x) for x in w[1:4])
            elif cur is not None and w[0] == "Ni":
                cur["Ni"] = float(w[1])
    mats = []
    for raw in out:
        m = dict(DIFFUSE_GREY)
        m["color"] = raw["Kd"]
        ke = np.asarray(raw["Ke"], np.float64)
        if (ke > 0).any():
            m["emittance"] = float(np.sqrt((ke * ke).sum()))
        ks = np.asarray(raw["Ks"], np.float64)
        if np.sqrt((ks * ks).sum()) > 0.0:
            m["has_reflective"] = 1.0
            m["specular_color"] = tuple(float(x) for x in ks)
        if raw["Ni"] > 1.01:
            m["has_refractive"] = 1.0
            m["ior"] = raw["Ni"]
        mats.append((raw["name"], m))
    return mats


def transform(trans, rot_deg, scale) -> np.ndarray:
    """T * Rx * Ry * Rz * S in float64, rotations in degrees."""
    def rot(deg, axis):
        a = float(deg) * math.pi / 180.0
        c, s = math.cos(a), math.sin(a)
        m = np.eye(4)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i], m[j, j] = c, c
        m[i, j], m[j, i] = (-s, s) if axis != 1 else (s, -s)
        return m
    t = np.eye(4)
    t[:3, 3] = np.asarray(trans, np.float64)
    s = np.diag([float(scale[0]), float(scale[1]), float(scale[2]), 1.0])
    return t @ rot(rot_deg[0], 0) @ rot(rot_deg[1], 1) @ rot(rot_deg[2], 2) @ s


def _obj(path: str, model: np.ndarray, override: int, mats: list) -> dict:
    """One OBJ mesh baked to world space: float32 [T, 3] corners and corner
    normals and [T] material ids; its MTL materials are appended to
    `mats`."""
    verts, norms, faces, mtl_names = [], [], [], {}
    cur = None
    base = os.path.dirname(path)
    with open(path, errors="replace") as f:
        for line in f:
            w = line.split()
            if not w or w[0].startswith("#"):
                continue
            if w[0] == "v":
                verts.append([float(x) for x in w[1:4]])
            elif w[0] == "vn":
                norms.append([float(x) for x in w[1:4]])
            elif w[0] == "mtllib":
                for name in w[1:]:
                    for nm, m in _mtl(os.path.join(base, name)):
                        if nm not in mtl_names:
                            mtl_names[nm] = len(mats)
                            mats.append(m)
            elif w[0] == "usemtl":
                cur = w[1] if len(w) > 1 else None
            elif w[0] == "f":
                corners = []
                for tok in w[1:]:
                    parts = tok.split("/")
                    vi = int(parts[0])
                    vi = vi - 1 if vi > 0 else len(verts) + vi
                    ni = None
                    if len(parts) >= 3 and parts[2]:
                        ni = int(parts[2])
                        ni = ni - 1 if ni > 0 else len(norms) + ni
                    corners.append((vi, ni))
                for k in range(1, len(corners) - 1):
                    tri = (corners[0], corners[k], corners[k + 1])
                    faces.append(([c[0] for c in tri],
                                  [c[1] for c in tri]
                                  if all(c[1] is not None for c in tri)
                                  else None, cur))
    m3 = model[:3, :3]
    v = np.asarray(verts, np.float64) @ m3.T + model[:3, 3]
    nrm = np.linalg.inv(m3).T
    n = np.asarray(norms, np.float64).reshape(-1, 3) @ nrm.T
    if len(n):
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.where(ln > 0, ln, 1.0)
    flip = np.linalg.det(m3) < 0.0
    out = {k: np.zeros((len(faces), 3), np.float32)
           for k in ("v0", "v1", "v2", "n0", "n1", "n2")}
    mat = np.zeros(len(faces), np.int32)
    grey = -1
    for i, (vi, ni, name) in enumerate(faces):
        a, b, c = vi
        if flip:
            b, c = c, b
            if ni is not None:
                ni = [ni[0], ni[2], ni[1]]
        out["v0"][i], out["v1"][i], out["v2"][i] = v[a], v[b], v[c]
        if ni is not None:
            out["n0"][i], out["n1"][i], out["n2"][i] = n[ni[0]], n[ni[1]], \
                n[ni[2]]
        else:
            fn = np.cross(v[b] - v[a], v[c] - v[a])
            ln = np.linalg.norm(fn)
            fn = fn / ln if ln > 0 else fn
            out["n0"][i] = out["n1"][i] = out["n2"][i] = fn
        if override >= 0:
            mat[i] = override
        elif name is not None and name in mtl_names:
            mat[i] = mtl_names[name]
        else:
            if grey < 0:
                grey = len(mats)
                mats.append(dict(DIFFUSE_GREY))
            mat[i] = grey
    out["mat"] = mat
    return out


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def orbit(zoom: float, theta: float, phi: float, look_at) -> dict:
    """The app's camera from spherical coordinates about `look_at`
    (main.cpp:423-441): position, view, and the unnormalized right and
    up, float64."""
    look_at = np.asarray(look_at, np.float64)
    off = np.array([zoom * math.sin(phi) * math.sin(theta),
                    zoom * math.cos(theta),
                    zoom * math.cos(phi) * math.sin(theta)])
    view = -_normalize(off)
    right = np.cross(view, np.array([0.0, 1.0, 0.0]))
    return {"position": off + look_at, "view": view, "right": right,
            "up": np.cross(right, view)}


def startup_orbit(cam: dict) -> tuple:
    """(zoom, theta, phi, look_at) of the app's start-up rebuild from the
    scene's eye and look-at (main.cpp:359-381)."""
    eye = np.asarray(cam["EYE"], np.float64)
    look = np.asarray(cam["LOOKAT"], np.float64)
    view = _normalize(look - eye)
    zoom = float(np.linalg.norm(eye - look))
    xz = _normalize(np.array([view[0], 0.0, view[2]]))
    zy = _normalize(np.array([0.0, view[1], view[2]]))
    phi = math.acos(min(max(float(xz @ np.array([0.0, 0.0, -1.0])), -1.0),
                        1.0))
    theta = math.acos(min(max(float(zy @ np.array([0.0, 1.0, 0.0])), -1.0),
                          1.0))
    return zoom, theta, phi, look


class Scene:
    """A parsed scene: materials, analytic geoms, triangles and camera.

    `path` is the scene JSON; `overrides` replaces camera-block entries
    (RES, DEPTH)."""

    def __init__(self, path: str, overrides: dict | None = None):
        with open(path) as f:
            data = json.load(f)
        names = list(data["Materials"])
        self.materials = [_material(data["Materials"][k]) for k in names]
        ids = {k: i for i, k in enumerate(names)}
        self.geoms = []        # (kind, material, inverse, inverse transpose)
        meshes = []
        here = os.path.dirname(os.path.abspath(path))
        for p in data["Objects"]:
            if p["TYPE"] == "mesh":
                obj = next(c for c in (
                    p["FILE"], os.path.join(here, p["FILE"]),
                    os.path.join(os.path.dirname(here), p["FILE"]),
                    os.path.join(here, os.path.basename(p["FILE"])),
                    os.path.join(here, "models",
                                 os.path.basename(p["FILE"])))
                    if os.path.exists(c))
                model = transform(p.get("TRANS", (0, 0, 0)),
                                  p.get("ROTAT", (0, 0, 0)),
                                  p.get("SCALE", (1, 1, 1)))
                meshes.append(_obj(obj, model,
                                   ids[p["MATERIAL"]] if "MATERIAL" in p
                                   else -1, self.materials))
                continue
            m = transform(p["TRANS"], p["ROTAT"], p["SCALE"])
            inv = np.linalg.inv(m)
            self.geoms.append((p["TYPE"], ids[p["MATERIAL"]],
                               inv.astype(np.float32),
                               inv.T.astype(np.float32)))
        keys = ("v0", "v1", "v2", "n0", "n1", "n2", "mat")
        self.tris = ({k: np.concatenate([mm[k] for mm in meshes])
                      for k in keys} if meshes else None)
        cam = dict(data["Camera"])
        cam.update(overrides or {})
        self.camera_block = cam
        self.width, self.height = int(cam["RES"][0]), int(cam["RES"][1])
        self.depth = int(cam["DEPTH"])
        fovy = float(cam["FOVY"])
        ys = math.tan(fovy * (math.pi / 180.0))
        xs = ys * self.width / self.height
        self.pixel_length = np.array([2.0 * xs / self.width,
                                      2.0 * ys / self.height], np.float32)
        self.focal = np.float32(cam.get("FOCAL_DISTANCE", 10.0))
        self.lens = np.float32(cam.get("LENS_RADIUS", 0.0))

    @property
    def n_tris(self) -> int:
        return 0 if self.tris is None else int(self.tris["v0"].shape[0])

    def camera(self, zoom: float, theta: float, phi: float,
               look_at) -> dict:
        """The orbit camera's float32 vectors."""
        return {k: v.astype(np.float32)
                for k, v in orbit(zoom, theta, phi, look_at).items()}

    def startup_camera(self) -> dict:
        """The camera the app starts with (its start-up orbit rebuild)."""
        return self.camera(*startup_orbit(self.camera_block))
