"""JSON scene loader: the port of pathtracer_tpu/scene/loader.py.

The parsing, camera derivation and BVH / treelet construction are the JAX
package's numpy host code, copied so that the port never imports JAX; only the
last step differs: `make_scene_arrays` puts every table on the `device` the
caller names. The 8-wide BVH tables and the brute-force tables are built only
when asked for (`wide_tables=True`, `brute_tables=True`), as in the JAX
loader.

`scene_from_jax_arrays` carries a scene the JAX package loaded across to the
port: the tests use it so both packages intersect the very same tables.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.math import PI, build_transformation_matrix, inverse_transpose, normalize
from . import obj as obj_loader
from .bvh import align_leaves, build_bvh
from .bvh8 import build_wide_bvh, concat_wide
from .types import (CUBE, MESH, SPHERE, BVHArrays, CameraArrays, GeomArrays,
                    MaterialArrays, RenderSettings, SceneArrays,
                    make_scene_arrays)

# tri count above which a mesh gets fat 288-tri treelets (48 rows)
BIG_MESH_TRIS = 24000


def _parse_material(p: dict) -> dict:
    m = {
        "color": (0.0, 0.0, 0.0),
        "specular_color": (0.0, 0.0, 0.0),
        "specular_exponent": 0.0,
        "has_reflective": 0.0,
        "has_refractive": 0.0,
        "ior": 0.0,
        "emittance": 0.0,
    }
    t = p["TYPE"]
    rgb = tuple(float(x) for x in p["RGB"])
    m["color"] = rgb
    if t == "Diffuse":
        pass
    elif t == "Emitting":
        m["emittance"] = float(p["EMITTANCE"])
    elif t == "Specular":
        roughness = float(np.clip(p.get("ROUGHNESS", 0.0), 0.0, 1.0))
        m["has_reflective"] = 1.0 - roughness
        m["specular_color"] = tuple(float(x) for x in p.get("SPECULAR_COLOR", rgb))
        m["specular_exponent"] = float(p.get("SPECULAR_EXPONENT", 0.0))
    elif t == "Refractive":
        transparency = float(np.clip(p.get("TRANSPARENCY", 0.0), 0.0, 1.0))
        m["has_refractive"] = 1.0 - transparency
        m["ior"] = float(p.get("IOR", 1.5))
        roughness = float(np.clip(p.get("ROUGHNESS", 0.0), 0.0, 1.0))
        m["has_reflective"] = 1.0 - roughness
        m["specular_color"] = tuple(float(x) for x in p.get("SPECULAR_COLOR", rgb))
        m["specular_exponent"] = float(p.get("SPECULAR_EXPONENT", 0.0))
    else:
        raise ValueError(f"unknown material TYPE {t!r}")
    return m


def derive_camera(eye, look_at, up, fovy_deg: float, width: int, height: int,
                  focal_distance: float, lens_radius: float) -> dict:
    """Camera vector/pixel-length derivation (scene.cpp:238-253)."""
    position = np.asarray(eye, dtype=np.float64)
    look_at = np.asarray(look_at, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    yscaled = np.tan(fovy_deg * (PI / 180.0))
    xscaled = (yscaled * width) / height
    view = normalize(look_at - position)
    right = normalize(np.cross(view, up))
    pixel_length = (2.0 * xscaled / float(width), 2.0 * yscaled / float(height))
    return {
        "position": position,
        "view": view,
        "up": up,
        "right": right,
        "pixel_length": pixel_length,
        "focal_distance": focal_distance,
        "lens_radius": lens_radius,
        "look_at": look_at,
    }


def apply_initial_orbit(cam: dict) -> dict:
    """Replicate the reference app's startup orbit-camera rebuild
    (main.cpp:359-381 + 423-441)."""
    view = np.asarray(cam["view"], dtype=np.float64)
    look_at = np.asarray(cam["look_at"], dtype=np.float64)
    zoom = float(np.linalg.norm(np.asarray(cam["position"]) - look_at))
    view_xz = np.array([view[0], 0.0, view[2]])
    view_zy = np.array([0.0, view[1], view[2]])
    phi = float(np.arccos(np.clip(np.dot(normalize(view_xz), [0, 0, -1]), -1, 1)))
    theta = float(np.arccos(np.clip(np.dot(normalize(view_zy), [0, 1, 0]), -1, 1)))
    return orbit_camera(cam, zoom, theta, phi, look_at)


def orbit_camera(cam: dict, zoom: float, theta: float, phi: float,
                 look_at: np.ndarray) -> dict:
    """Rebuild camera from spherical coords (main.cpp:423-441)."""
    offset = np.array([
        zoom * np.sin(phi) * np.sin(theta),
        zoom * np.cos(theta),
        zoom * np.cos(phi) * np.sin(theta),
    ])
    v = -normalize(offset)
    u = np.array([0.0, 1.0, 0.0])
    r = np.cross(v, u)          # unnormalized, as in reference
    new_up = np.cross(r, v)     # unnormalized, as in reference
    out = dict(cam)
    out["position"] = offset + look_at
    out["view"] = v
    out["up"] = new_up
    out["right"] = r
    out["look_at"] = look_at
    return out


def load_scene(path: str, device, orbit: bool = True,
               overrides: Optional[dict] = None, brute_tables: bool = False,
               wide_tables: bool = False, bvh_impl: Optional[str] = None
               ) -> Tuple[SceneArrays, RenderSettings]:
    """Load a scene JSON; returns (tensors on `device`, static settings).

    `orbit=True` applies the reference app's startup camera rebuild.
    `overrides` patches camera-block values (e.g. {"RES": [64, 64]}).
    The fat-leaf size of each mesh follows its triangle count: 288 above
    BIG_MESH_TRIS, else 96, as in the JAX loader. `brute_tables=True` also
    packs the brute-force intersector's tables (bvh_impl="brute");
    `wide_tables=True` also builds the 8-wide BVH of every mesh
    (bvh_impl="wide" / "wide_nosort", the binned wide fallback).
    `bvh_impl`, when given, becomes the settings' mesh intersector and
    loads the tables it needs (render.py's --bvh handling)."""
    if bvh_impl == "brute":
        brute_tables = True
    if bvh_impl in ("wide", "wide_nosort"):
        wide_tables = True
    device = torch.device(device)
    with open(path, "r") as f:
        data = json.load(f)

    materials = []
    mat_name_to_id = {}
    for name, p in data["Materials"].items():
        mat_name_to_id[name] = len(materials)
        materials.append(_parse_material(p))

    scene_dir = os.path.dirname(os.path.abspath(path))

    geoms = []
    all_nodes = {"bounds_min": [], "bounds_max": [], "tri_first": [],
                 "tri_count": [], "second_child": [], "parent": [],
                 "sibling": []}
    all_tris = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2", "material_id")}
    node_count = 0
    tri_count = 0
    scene_tre_rows = 16   # rows-per-treelet bound over all meshes (min 16)
    wide_meshes = []      # per-mesh (wide_nodes, tris8) for the 8-wide walk

    for p in data["Objects"]:
        t = p["TYPE"]
        if t == "mesh":
            obj_file = p["FILE"]
            # as given, then relative to the scene file, its parent, and the
            # scene's models/ folder
            candidates = [
                obj_file,
                os.path.join(scene_dir, obj_file),
                os.path.join(os.path.dirname(scene_dir), obj_file),
                os.path.join(scene_dir, os.path.basename(obj_file)),
                os.path.join(scene_dir, "models", os.path.basename(obj_file)),
            ]
            resolved = next((c for c in candidates if os.path.exists(c)), None)
            if resolved is None:
                raise FileNotFoundError(f"mesh file {obj_file!r} not found")
            override_id = mat_name_to_id[p["MATERIAL"]] if "MATERIAL" in p else -1
            trans = p.get("TRANS", (0.0, 0.0, 0.0))
            rotat = p.get("ROTAT", (0.0, 0.0, 0.0))
            scal = p.get("SCALE", (1.0, 1.0, 1.0))
            tris = obj_loader.load_obj(resolved, override_id, trans, rotat, scal,
                                       materials)
            n_tris = len(tris["v0"])
            ml = 288 if n_tris > BIG_MESH_TRIS else 96
            scene_tre_rows = max(scene_tre_rows, -(-ml // 6))
            nodes, reordered = build_bvh(tris, max_leaf=ml)
            nodes, reordered = align_leaves(nodes, reordered)
            if wide_tables:
                # the 8-wide walk's own small-leaf tree and triangle order
                wide_meshes.append(build_wide_bvh(tris))
            # global offset fix-up (scene.cpp:178-189)
            n_new = nodes["tri_first"].shape[0]
            is_leaf = nodes["tri_count"] > 0
            fixed_tri = np.where(is_leaf, nodes["tri_first"] + tri_count, -1)
            fixed_sc = np.where(is_leaf, nodes["second_child"],
                                nodes["second_child"] + node_count)
            fixed_par = np.where(nodes["parent"] >= 0,
                                 nodes["parent"] + node_count, -1)
            fixed_sib = np.where(nodes["sibling"] >= 0,
                                 nodes["sibling"] + node_count, -1)
            all_nodes["bounds_min"].append(nodes["bounds_min"])
            all_nodes["bounds_max"].append(nodes["bounds_max"])
            all_nodes["tri_first"].append(fixed_tri.astype(np.int32))
            all_nodes["tri_count"].append(nodes["tri_count"].astype(np.int32))
            all_nodes["second_child"].append(fixed_sc.astype(np.int32))
            all_nodes["parent"].append(fixed_par.astype(np.int32))
            all_nodes["sibling"].append(fixed_sib.astype(np.int32))
            for k in all_tris:
                all_tris[k].append(reordered[k])
            geoms.append({
                "type": MESH,
                "material_id": override_id if override_id >= 0 else 0,
                "transform": np.eye(4, dtype=np.float32),
                "inverse_transform": np.eye(4, dtype=np.float32),
                "inv_transpose": np.eye(4, dtype=np.float32),
                "root_node": node_count,
            })
            node_count += n_new
            tri_count += reordered["v0"].shape[0]
            continue

        gtype = CUBE if t == "cube" else SPHERE
        tf = build_transformation_matrix(p["TRANS"], p["ROTAT"], p["SCALE"])
        geoms.append({
            "type": gtype,
            "material_id": mat_name_to_id[p["MATERIAL"]],
            "transform": tf,
            "inverse_transform": np.linalg.inv(tf),
            "inv_transpose": inverse_transpose(tf),
            "root_node": -1,
        })

    cam_data = dict(data["Camera"])
    if overrides:
        cam_data.update(overrides)
    width, height = int(cam_data["RES"][0]), int(cam_data["RES"][1])
    fovy = float(cam_data["FOVY"])
    cam = derive_camera(
        cam_data["EYE"], cam_data["LOOKAT"], cam_data["UP"], fovy, width, height,
        focal_distance=float(cam_data.get("FOCAL_DISTANCE", 10.0)),
        lens_radius=float(cam_data.get("LENS_RADIUS", 0.0)),
    )
    if orbit:
        cam = apply_initial_orbit(cam)

    from ..ops.camera import pick_tile
    settings = RenderSettings(
        width=width,
        height=height,
        # tile-major lane order only pays for mesh traversal coherence
        tile=pick_tile(width, height) if node_count else None,
        # mesh scenes default to the binned-treelet intersector
        bvh_impl=bvh_impl or ("binned" if node_count else "pallas"),
        any_glossy=any(m["has_reflective"] != 0.0 and m["has_refractive"] == 0.0
                       for m in materials),
        any_refractive=any(m["has_refractive"] != 0.0 for m in materials),
        trace_depth=int(cam_data["DEPTH"]),
        iterations=int(cam_data["ITERATIONS"]),
        image_name=str(cam_data.get("FILE", "render")),
        look_at=tuple(float(x) for x in cam_data["LOOKAT"]),
        fovy_deg=fovy,
        geom_types=tuple(int(g["type"]) for g in geoms),
    )

    if node_count:
        bvh_nodes = {k: np.concatenate(v, axis=0) for k, v in all_nodes.items()}
        bvh_tris = {k: np.concatenate(v, axis=0) for k, v in all_tris.items()}
    else:
        bvh_nodes, bvh_tris = None, None

    wide_data = concat_wide(wide_meshes) if wide_meshes else None
    arrays = make_scene_arrays(geoms, materials, bvh_nodes, bvh_tris, cam,
                               device, brute_tables=brute_tables,
                               wide_data=wide_data, tre_rows=scene_tre_rows)
    return arrays, settings


def scene_from_jax_arrays(arrays: dict, device) -> SceneArrays:
    """The port's SceneArrays from the leaves of a JAX-loaded SceneArrays.

    `arrays` maps each leaf's dotted field path in the JAX NamedTuple
    ("geoms.transform", "bvh.min_x", "camera.view", "tris_packed",
    "treelet_rows", ...) to a numpy array. Every table is carried over as it
    is; the rows-per-treelet bound is `treelet_rows`' length, as in JAX.
    """
    device = torch.device(device)

    def t(key):
        return torch.as_tensor(np.array(arrays[key]), device=device)

    def group(cls, prefix):
        return cls(**{f.name: t(f"{prefix}.{f.name}")
                      for f in dataclasses.fields(cls)})

    geoms = group(GeomArrays, "geoms")
    gtype = np.asarray(arrays["geoms.gtype"])
    roots = np.asarray(arrays["geoms.root_node"])
    return SceneArrays(
        geoms=geoms,
        materials=group(MaterialArrays, "materials"),
        bvh=group(BVHArrays, "bvh"),
        camera=group(CameraArrays, "camera"),
        bvh_packed_f=t("bvh_packed_f"), bvh_packed_i=t("bvh_packed_i"),
        tris_packed=t("tris_packed"),
        treelet_f=t("treelet_f"), treelet_i=t("treelet_i"),
        treelet_super=t("treelet_super"),
        tris_mxu_c=t("tris_mxu_c"), tris_mxu_n=t("tris_mxu_n"),
        nodes8_f=t("nodes8_f"), nodes8_i=t("nodes8_i"), tris8=t("tris8"),
        wide_root=t("wide_root"),
        tre_rows=int(np.asarray(arrays["treelet_rows"]).shape[0]),
        mesh_roots=tuple(int(r) for g, r in zip(gtype, roots) if g == MESH),
        # the JAX placeholder forest is all zeros: no slot of any kind
        wide_built=bool(np.asarray(arrays["nodes8_i"]).any()))
