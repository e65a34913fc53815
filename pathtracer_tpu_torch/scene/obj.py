"""Wavefront OBJ/MTL loader (host-side, pure Python + NumPy).

A copy of pathtracer_tpu/scene/obj.py: the port imports nothing of the JAX
package.

Replaces the reference's vendored tinyobjloader usage
(reference src/scene.cpp:261-431). Semantics replicated:
  - faces are triangulated (tinyobj default `triangulate=true`): polygon fans
  - vertices/normals baked to WORLD space at load via the model matrix
    (scene.cpp:316-330); normal matrix = transpose(inverse(mat3)); winding
    flipped when determinant < 0 (scene.cpp:321,349-350)
  - missing normals -> face normal fallback (scene.cpp:382-385)
  - MTL -> Material mapping (scene.cpp:289-314): diffuse->color, |emission|>0 ->
    emittance=length(emission), |specular|>0 -> has_reflective=1 + exponent
    (shininess or 50), ior>1.01 -> has_refractive=1
  - per-face material: MTL id, else JSON override, else grey-0.5 default
    (scene.cpp:387-401)
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.math import build_transformation_matrix


def _parse_mtl(path: str) -> Dict[str, dict]:
    """Parse an MTL file into {name: raw material dict}."""
    mats: Dict[str, dict] = {}
    cur: Optional[dict] = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = {"Kd": (0.6, 0.6, 0.6), "Ks": (0.0, 0.0, 0.0),
                       "Ke": (0.0, 0.0, 0.0), "Ni": 1.0, "Ns": 0.0}
                mats[parts[1] if len(parts) > 1 else ""] = cur
            elif cur is not None and key in ("Kd", "Ks", "Ke"):
                cur[key] = tuple(float(x) for x in parts[1:4])
            elif cur is not None and key in ("Ni", "Ns"):
                cur[key] = float(parts[1])
    return mats


def _mtl_to_material(raw: dict) -> dict:
    """MTL -> engine material dict (reference scene.cpp:289-314)."""
    m = {
        "color": tuple(raw.get("Kd", (0.6, 0.6, 0.6))),
        "specular_color": (0.0, 0.0, 0.0),
        "specular_exponent": 0.0,
        "has_reflective": 0.0,
        "has_refractive": 0.0,
        "ior": 0.0,
        "emittance": 0.0,
    }
    ke = np.asarray(raw.get("Ke", (0.0, 0.0, 0.0)), dtype=np.float64)
    if (ke > 0).any():
        m["emittance"] = float(np.linalg.norm(ke))
    ks = np.asarray(raw.get("Ks", (0.0, 0.0, 0.0)), dtype=np.float64)
    if np.linalg.norm(ks) > 0.0:
        m["has_reflective"] = 1.0
        m["specular_color"] = tuple(float(x) for x in ks)
        ns = raw.get("Ns", 0.0)
        m["specular_exponent"] = float(ns) if ns > 0 else 50.0
    ni = float(raw.get("Ni", 1.0))
    if ni > 1.01:
        m["has_refractive"] = 1.0
        m["ior"] = ni
    return m


def load_obj(
    obj_path: str,
    override_material_id: int,
    translation,
    rotation_deg,
    scale_vec,
    materials_out: List[dict],
) -> dict:
    """Load an OBJ file, bake to world space, return triangle SoA dict.

    `materials_out` is the scene's growing material list; MTL materials and the
    grey default are appended to it, mirroring scene.cpp's global material
    vector. Returns {"v0".."n2": [T,3] float32, "material_id": [T] int32}.
    """
    model = build_transformation_matrix(translation, rotation_deg, scale_vec)
    m3 = model[:3, :3]
    normal_matrix = np.linalg.inv(m3).T
    invert_winding = np.linalg.det(m3) < 0.0

    verts: List[Tuple[float, float, float]] = []
    norms: List[Tuple[float, float, float]] = []
    # faces: list of (vertex idx triple, normal idx triple or None, mtl name or None)
    faces: List[Tuple[Tuple[int, int, int], Optional[Tuple[int, int, int]], Optional[str]]] = []
    mtl_raw: Dict[str, dict] = {}
    cur_mtl: Optional[str] = None

    base_dir = os.path.dirname(obj_path)
    with open(obj_path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vn":
                norms.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "mtllib":
                for name in parts[1:]:
                    mtl_raw.update(_parse_mtl(os.path.join(base_dir, name)))
            elif key == "usemtl":
                cur_mtl = parts[1] if len(parts) > 1 else None
            elif key == "f":
                corners = []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    vi = int(fields[0])
                    vi = vi - 1 if vi > 0 else len(verts) + vi
                    ni = None
                    if len(fields) >= 3 and fields[2]:
                        ni = int(fields[2])
                        ni = ni - 1 if ni > 0 else len(norms) + ni
                    corners.append((vi, ni))
                # Fan triangulation (tinyobj default behavior)
                for k in range(1, len(corners) - 1):
                    tri = (corners[0], corners[k], corners[k + 1])
                    vidx = tuple(c[0] for c in tri)
                    nidx = (
                        tuple(c[1] for c in tri)
                        if all(c[1] is not None for c in tri)
                        else None
                    )
                    faces.append((vidx, nidx, cur_mtl))

    # Register MTL materials in scene material list (scene.cpp:289-314)
    mtl_to_global: Dict[str, int] = {}
    for name, raw in mtl_raw.items():
        mtl_to_global[name] = len(materials_out)
        materials_out.append(_mtl_to_material(raw))

    v_arr = np.asarray(verts, dtype=np.float64) if verts else np.zeros((0, 3))
    n_arr = np.asarray(norms, dtype=np.float64) if norms else np.zeros((0, 3))

    # Bake to world space
    v_world = v_arr @ m3.T + model[:3, 3]
    if len(n_arr):
        n_world = n_arr @ normal_matrix.T
        lens = np.linalg.norm(n_world, axis=1, keepdims=True)
        n_world = n_world / np.where(lens > 0, lens, 1.0)
    else:
        n_world = n_arr

    T = len(faces)
    out = {k: np.zeros((T, 3), dtype=np.float32)
           for k in ("v0", "v1", "v2", "n0", "n1", "n2")}
    mat_ids = np.zeros((T,), dtype=np.int32)
    default_grey_id = -1

    for i, (vidx, nidx, mtl_name) in enumerate(faces):
        i0, i1, i2 = vidx
        nn = nidx
        if invert_winding:
            i1, i2 = i2, i1
            if nn is not None:
                nn = (nn[0], nn[2], nn[1])
        p0, p1, p2 = v_world[i0], v_world[i1], v_world[i2]
        out["v0"][i], out["v1"][i], out["v2"][i] = p0, p1, p2
        if nn is not None:
            out["n0"][i] = n_world[nn[0]]
            out["n1"][i] = n_world[nn[1]]
            out["n2"][i] = n_world[nn[2]]
        else:
            fn = np.cross(p1 - p0, p2 - p0)
            ln = np.linalg.norm(fn)
            fn = fn / ln if ln > 0 else fn
            out["n0"][i] = out["n1"][i] = out["n2"][i] = fn

        if override_material_id != -1:
            mat_ids[i] = override_material_id
        elif mtl_name is not None and mtl_name in mtl_to_global:
            mat_ids[i] = mtl_to_global[mtl_name]
        else:
            # grey 0.5 default (scene.cpp:394-400); reference appends a new
            # material per unmatched face — we dedupe to one shared default.
            if default_grey_id < 0:
                default_grey_id = len(materials_out)
                materials_out.append({
                    "color": (0.5, 0.5, 0.5), "specular_color": (0.0, 0.0, 0.0),
                    "specular_exponent": 0.0, "has_reflective": 0.0,
                    "has_refractive": 0.0, "ior": 0.0, "emittance": 0.0,
                })
            mat_ids[i] = default_grey_id

    out["material_id"] = mat_ids
    return out
