"""Scene data model: flat SoA tensors on one device, plus static settings.

The port of pathtracer_tpu/scene/types.py. `SceneArrays` is a dataclass of
tensors that all live on the device given to `make_scene_arrays`;
`RenderSettings` is the same frozen, hashable configuration as the JAX
package's. The packed `[rows, 128]` tables keep the JAX layouts byte for byte,
so the CUDA kernels (ops/binned.py, ops/bvh_packet.py) read exactly the tables
the Pallas kernels read, and the tests can hold one against the other.

Left out of this slice: the brute-force MXU tables, the 8-wide BVH tables,
the per-chunk gate table and the per-triangle attribute table, which only the
intersectors and ablations not ported yet read.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# GeomType enum (reference sceneStructs.h:14-19)
SPHERE = 0
CUBE = 1
MESH = 2

NODES_PER_FROW = 16   # 16 nodes x 8 f32 fields = 128 lanes
NODES_PER_IROW = 32   # 32 nodes x 4 i32 fields = 128 lanes
TRIS_PER_ROW = 6      # 6 tris x 20 f32 fields = 120 lanes (+8 pad)
TRI_STRIDE = 20
TREELETS_PER_FROW = 16  # 16 treelets x 8 f32 fields (bounds) = 128 lanes
TREELETS_PER_IROW = 32  # 32 treelets x 4 i32 fields (row range) = 128 lanes
TREELET_NONE = 0x3FFFFFF  # "no treelet" id sentinel
MAX_TRE_ROWS = 16         # default rows-per-treelet bound


@dataclasses.dataclass
class GeomArrays:
    """SoA of reference `Geom` (sceneStructs.h:27-39)."""

    gtype: torch.Tensor              # [G] int32 in {SPHERE, CUBE, MESH}
    material_id: torch.Tensor        # [G] int32
    transform: torch.Tensor          # [G, 4, 4] f32
    inverse_transform: torch.Tensor  # [G, 4, 4] f32
    inv_transpose: torch.Tensor      # [G, 4, 4] f32
    root_node: torch.Tensor          # [G] int32; BVH root for MESH, -1 otherwise


@dataclasses.dataclass
class MaterialArrays:
    """SoA of reference `Material` (sceneStructs.h:71-83)."""

    color: torch.Tensor              # [M, 3] f32 (albedo)
    specular_color: torch.Tensor     # [M, 3] f32
    specular_exponent: torch.Tensor  # [M] f32
    has_reflective: torch.Tensor     # [M] f32 (1 - roughness)
    has_refractive: torch.Tensor     # [M] f32 (1 - transparency)
    ior: torch.Tensor                # [M] f32
    emittance: torch.Tensor          # [M] f32


@dataclasses.dataclass
class BVHArrays:
    """SoA of the flattened DFS BVH (see pathtracer_tpu/scene/types.py)."""

    min_x: torch.Tensor  # [N] f32
    min_y: torch.Tensor
    min_z: torch.Tensor
    max_x: torch.Tensor
    max_y: torch.Tensor
    max_z: torch.Tensor
    tri_first: torch.Tensor     # [N] int32, -1 for interior
    tri_count: torch.Tensor     # [N] int32, 0 for interior
    second_child: torch.Tensor  # [N] int32
    parent: torch.Tensor        # [N] int32, -1 at root
    sibling: torch.Tensor       # [N] int32, right sibling of a left child


@dataclasses.dataclass
class CameraArrays:
    """Camera parameters (reference sceneStructs.h:85-97)."""

    position: torch.Tensor        # [3]
    view: torch.Tensor            # [3]
    up: torch.Tensor              # [3]
    right: torch.Tensor           # [3]
    pixel_length: torch.Tensor    # [2]
    lens_radius: torch.Tensor     # [] scalar
    focal_distance: torch.Tensor  # [] scalar


@dataclasses.dataclass
class SceneArrays:
    """Everything the device needs, all on one device."""

    geoms: GeomArrays
    materials: MaterialArrays
    bvh: BVHArrays
    camera: CameraArrays
    # row-packed tables for the packet walk (pack_bvh_tables)
    bvh_packed_f: torch.Tensor   # [Rf, 128] f32
    bvh_packed_i: torch.Tensor   # [Ri, 128] i32
    tris_packed: torch.Tensor    # [Rt, 128] f32
    # treelet tables for the binned intersector (pack_treelet_tables)
    treelet_f: torch.Tensor      # [ceil(T/16), 128] f32 bounds
    treelet_i: torch.Tensor      # [ceil(T/32), 128] i32 row ranges
    treelet_super: torch.Tensor  # [ceil(T/16), 128] f32 per-row union bounds
    # host-side statics: the rows-per-treelet bound (the JAX package carries
    # it as the shape of `treelet_rows`) and the BVH root of every mesh geom
    tre_rows: int
    mesh_roots: tuple

    @property
    def device(self) -> torch.device:
        return self.tris_packed.device


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static, hashable render configuration (the JAX package's, minus the
    sorted/compact modes and the threefry switch this port does not have)."""

    width: int
    height: int
    trace_depth: int = 8
    iterations: int = 5000
    image_name: str = "render"
    jitter: bool = True          # JITTER: Gaussian AA, sigma=0.005, clamp +-0.5
    dof: bool = True             # DOF: thin-lens, active iff lens_radius > 0
    # material-table capability flags (set by the loader): BSDF branches no
    # material can take are not computed (ops/bsdf.py scatter_ray)
    any_glossy: bool = True
    any_refractive: bool = True
    depth_quirk: bool = False    # reference termination quirk (ops/bsdf.py)
    rr_start: int = 0            # Russian roulette from this depth (0 = off)
    # mesh intersector: "binned" (ops/binned.py) or "pallas", the packet walk
    # alone (ops/bvh_packet.py); the names follow the JAX package
    bvh_impl: str = "pallas"
    look_at: tuple = (0.0, 0.0, 0.0)
    fovy_deg: float = 45.0
    geom_types: tuple = ()       # static per-geom type tuple
    tile: tuple | None = None    # tile-major lane order (tile_h, tile_w)

    def pixel_map(self):
        """lane -> pixel id function (identity when untiled)."""
        if self.tile is None:
            return lambda lane: lane
        from ..ops.camera import tile_pixel_map
        return tile_pixel_map(self.width, self.height, *self.tile)

    @property
    def pixel_count(self) -> int:
        return self.width * self.height


def repartition_treelet_rows(row_min, row_max, max_rows: int,
                             c0: float = 20.0, lam: float = None):
    """DP re-partition of the DFS-ordered triangle rows into treelets:
    minimize sum_g area(union(rows of g)) * (c0 + n_rows(g)) + lam per
    treelet, n_rows(g) <= max_rows (pathtracer_tpu/scene/types.py:98 has the
    derivation). Returns (row0, nrows) int arrays, a partition of
    [0, n_rows_total)."""
    n = row_min.shape[0]
    w = min(max_rows, n)
    # windowed unions: umin[k-1, i] = min over rows [i, i+k)
    umin = np.full((w, n, 3), np.inf, np.float32)
    umax = np.full((w, n, 3), -np.inf, np.float32)
    umin[0], umax[0] = row_min, row_max
    for k in range(1, w):
        umin[k, :n - k] = np.minimum(umin[k - 1, :n - k], row_min[k:])
        umax[k, :n - k] = np.maximum(umax[k - 1, :n - k], row_max[k:])
    d = np.maximum(umax - umin, 0.0)
    area = 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])               # [w, n]
    ks = np.arange(1, w + 1, dtype=np.float64)
    if lam is None:
        d1 = np.maximum(row_max - row_min, 0.0)
        a1 = 2.0 * (d1[:, 0] * d1[:, 1] + d1[:, 1] * d1[:, 2]
                    + d1[:, 2] * d1[:, 0])
        lam = float(a1.mean()) * (c0 + max_rows) * 2.0
    cost_w = area.astype(np.float64) * (c0 + ks)[:, None] + lam

    best = np.full(n + 1, np.inf)
    best[n] = 0.0
    choice = np.zeros(n, np.int32)
    for i in range(n - 1, -1, -1):
        kmax = min(w, n - i)
        cand = cost_w[:kmax, i] + best[i + 1:i + 1 + kmax]
        k = int(np.argmin(cand))
        best[i] = cand[k]
        choice[i] = k + 1
    row0, i = [], 0
    while i < n:
        row0.append(i)
        i += int(choice[i])
    row0 = np.asarray(row0, np.int64)
    nrows = np.diff(np.append(row0, n)).astype(np.int64)
    return row0, nrows


def pack_treelet_tables(nodes: dict, tris: dict, max_rows: int = None):
    """Treelet tables for the binned intersector, in the JAX layout
    (pathtracer_tpu/scene/types.py:170), with the default DP repartition.

      treelet_f [ceil(T/16), 128] f32: 8 fields per treelet
          (min_x, min_y, min_z, max_x, max_y, max_z, pad, pad)
      treelet_i [ceil(T/32), 128] i32: 4 fields (row_first, n_rows, pad, pad)
      treelet_super [ceil(T/16), 128] f32: the union box of each treelet_f
          row at lanes 0..5
    Padding treelets carry inverted boxes (min=+inf) and n_rows=0.
    Returns numpy arrays.
    """
    leaf = nodes["tri_count"] > 0
    order = np.argsort(nodes["tri_first"][leaf], kind="stable")
    lmin = np.asarray(nodes["bounds_min"], np.float32)[leaf][order]
    lmax = np.asarray(nodes["bounds_max"], np.float32)[leaf][order]
    first = nodes["tri_first"][leaf][order]
    count = nodes["tri_count"][leaf][order]
    assert (first % TRIS_PER_ROW == 0).all()
    if max_rows is None:
        max_rows = MAX_TRE_ROWS

    # per-TRI-ROW AABBs over the reordered triangle array (zero-padding tris
    # beyond nt are degenerate -> excluded)
    nt = tris["v0"].shape[0]
    rows_t = -(-nt // TRIS_PER_ROW)
    vmin = np.minimum(np.minimum(tris["v0"], tris["v1"]), tris["v2"])
    vmax = np.maximum(np.maximum(tris["v0"], tris["v1"]), tris["v2"])
    pmin = np.full((rows_t * TRIS_PER_ROW, 3), np.inf, np.float32)
    pmax = np.full((rows_t * TRIS_PER_ROW, 3), -np.inf, np.float32)
    pmin[:nt] = vmin
    pmax[:nt] = vmax
    row_min = pmin.reshape(rows_t, TRIS_PER_ROW, 3).min(axis=1)
    row_max = pmax.reshape(rows_t, TRIS_PER_ROW, 3).max(axis=1)

    if row_min.shape[0] > 1:
        t_row0, t_nrows = repartition_treelet_rows(row_min, row_max,
                                                   max_rows)
        first = t_row0 * TRIS_PER_ROW
        count = t_nrows * TRIS_PER_ROW
        # treelet boxes = exact unions of their rows' AABBs
        lmin = np.stack([row_min[r0:r0 + k].min(axis=0)
                         for r0, k in zip(t_row0, t_nrows)]).astype(
            np.float32)
        lmax = np.stack([row_max[r0:r0 + k].max(axis=0)
                         for r0, k in zip(t_row0, t_nrows)]).astype(
            np.float32)
    T = first.shape[0]

    tf = -(-T // TREELETS_PER_FROW) * TREELETS_PER_FROW
    f = np.zeros((tf, 8), np.float32)
    f[:, 0:3] = np.float32(np.inf)
    f[:, 3:6] = -np.float32(np.inf)
    f[:T, 0:3] = lmin
    f[:T, 3:6] = lmax
    packed_f = f.reshape(-1, 128)

    ti = -(-T // TREELETS_PER_IROW) * TREELETS_PER_IROW
    i = np.zeros((ti, 4), np.int32)
    i[:T, 0] = first // TRIS_PER_ROW
    i[:T, 1] = -(-count // TRIS_PER_ROW)
    assert int(i[:, 1].max(initial=0)) <= max_rows, (
        "treelet exceeds the rows bound — lower max_leaf or raise tre_rows")
    packed_i = i.reshape(-1, 128)

    # SUPER table: one row per treelet_f row (16 consecutive DFS treelets)
    # with the union bounds at lanes 0..5
    n_rows_f = packed_f.shape[0]
    grp = f.reshape(n_rows_f, TREELETS_PER_FROW, 8)
    sup = np.zeros((n_rows_f, 128), np.float32)
    sup[:, 0:3] = grp[:, :, 0:3].min(axis=1)
    sup[:, 3:6] = grp[:, :, 3:6].max(axis=1)
    return packed_f, packed_i, sup


def pack_bvh_tables(nodes: dict, tris: dict):
    """Pack BVH + triangles into 128-lane rows, in the JAX layout
    (pathtracer_tpu/scene/types.py:434):
      nodes_f [ceil(Nn/16), 128] f32: per node 8 fields
          (min_x,min_y,min_z,max_x,max_y,max_z, pad, pad)
      nodes_i [ceil(Nn/32), 128] i32: per node 4 fields
          (tri_first, tri_count, sibling, parent)
      tris_f  [ceil(Nt/6), 128] f32: per tri 20 fields
          (v0, e1, e2, n0, n1, n2, material_id, pad)
    Returns numpy arrays.
    """
    nn = nodes["tri_first"].shape[0]
    leaf = nodes["tri_count"] > 0
    assert (nodes["tri_first"][leaf] % TRIS_PER_ROW == 0).all(), (
        "leaf ranges must be row-aligned (scene/bvh.py align_leaves)")
    f = np.zeros((nn, 8), np.float32)
    f[:, 0:3] = nodes["bounds_min"]
    f[:, 3:6] = nodes["bounds_max"]
    rows_f = -(-nn // NODES_PER_FROW)
    packed_f = np.zeros((rows_f * NODES_PER_FROW, 8), np.float32)
    packed_f[:nn] = f
    packed_f = packed_f.reshape(rows_f, 128)

    i = np.zeros((nn, 4), np.int32)
    i[:, 0] = nodes["tri_first"]
    i[:, 1] = nodes["tri_count"]
    i[:, 2] = nodes["sibling"]
    i[:, 3] = nodes["parent"]
    rows_i = -(-nn // NODES_PER_IROW)
    packed_i = np.zeros((rows_i * NODES_PER_IROW, 4), np.int32)
    packed_i[:nn] = i
    # padding nodes must terminate a walk instantly if ever visited
    packed_i[nn:, 2] = -1
    packed_i[nn:, 3] = -1
    packed_i = packed_i.reshape(rows_i, 128)

    nt = tris["v0"].shape[0]
    t = np.zeros((nt, TRI_STRIDE), np.float32)
    t[:, 0:3] = tris["v0"]
    t[:, 3:6] = tris["v1"] - tris["v0"]   # e1, precomputed
    t[:, 6:9] = tris["v2"] - tris["v0"]   # e2
    t[:, 9:12] = tris["n0"]
    t[:, 12:15] = tris["n1"]
    t[:, 15:18] = tris["n2"]
    t[:, 18] = tris["material_id"].astype(np.float32)
    rows_t = -(-nt // TRIS_PER_ROW)
    packed_t = np.zeros((rows_t, 128), np.float32)
    flat = np.zeros((rows_t * TRIS_PER_ROW, TRI_STRIDE), np.float32)
    flat[:nt] = t
    packed_t[:, :TRIS_PER_ROW * TRI_STRIDE] = flat.reshape(
        rows_t, TRIS_PER_ROW * TRI_STRIDE)
    return packed_f, packed_i, packed_t


def _inverted_boxes(shape) -> np.ndarray:
    """Zero table with 8-field records whose boxes are inverted (min=+inf,
    max=-inf): a slab test against them never enters."""
    a = np.zeros(shape, np.float32).reshape(-1, 8)
    a[:, 0:3] = np.inf
    a[:, 3:6] = -np.inf
    return a.reshape(shape)


def make_scene_arrays(geom_list, material_list, bvh_nodes, bvh_tris, camera,
                      device, tre_rows: int = None) -> SceneArrays:
    """Build SceneArrays on `device` from the loader's host lists/dicts
    (pathtracer_tpu/scene/types.py:698, minus the tables this slice does not
    read)."""
    assert len(geom_list) > 0, "scene must have at least one geom"
    assert len(material_list) > 0, "scene must have at least one material"

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)

    def f32(a):
        return dev(a, np.float32)

    def i32(a):
        return dev(a, np.int32)

    geoms = GeomArrays(
        gtype=i32([x["type"] for x in geom_list]),
        material_id=i32([x["material_id"] for x in geom_list]),
        transform=f32(np.stack([np.asarray(x["transform"], np.float32)
                                for x in geom_list])),
        inverse_transform=f32(np.stack(
            [np.asarray(x["inverse_transform"], np.float32)
             for x in geom_list])),
        inv_transpose=f32(np.stack([np.asarray(x["inv_transpose"], np.float32)
                                    for x in geom_list])),
        root_node=i32([x.get("root_node", -1) for x in geom_list]),
    )

    def mat_field(key, default):
        return f32([x.get(key, default) for x in material_list])

    materials = MaterialArrays(
        color=mat_field("color", (0.0, 0.0, 0.0)),
        specular_color=mat_field("specular_color", (0.0, 0.0, 0.0)),
        specular_exponent=mat_field("specular_exponent", 0.0),
        has_reflective=mat_field("has_reflective", 0.0),
        has_refractive=mat_field("has_refractive", 0.0),
        ior=mat_field("ior", 0.0),
        emittance=mat_field("emittance", 0.0),
    )

    if bvh_nodes is None or len(bvh_nodes["bounds_min"]) == 0:
        # never-empty placeholders, the same as the JAX package's
        bmin = np.full((1, 3), np.inf, np.float32)
        bmax = np.full((1, 3), -np.inf, np.float32)
        node_i = {"tri_first": [-1], "tri_count": [0], "second_child": [0],
                  "parent": [-1], "sibling": [-1]}
        packed_f = np.zeros((1, 128), np.float32)
        packed_i = np.full((1, 128), -1, np.int32)
        packed_t = np.zeros((1, 128), np.float32)
        treelet_f = _inverted_boxes((1, 128))
        treelet_i = np.zeros((1, 128), np.int32)
        treelet_super = np.zeros((1, 128), np.float32)
        treelet_super[:, 0:3] = np.inf
        treelet_super[:, 3:6] = -np.inf
    else:
        bmin = np.asarray(bvh_nodes["bounds_min"], dtype=np.float32)
        bmax = np.asarray(bvh_nodes["bounds_max"], dtype=np.float32)
        node_i = bvh_nodes
        tri_dict = {k: np.asarray(bvh_tris[k], dtype=np.float32)
                    for k in ("v0", "v1", "v2", "n0", "n1", "n2")}
        tri_dict["material_id"] = np.asarray(bvh_tris["material_id"],
                                             dtype=np.int32)
        packed_f, packed_i, packed_t = pack_bvh_tables(bvh_nodes, tri_dict)
        treelet_f, treelet_i, treelet_super = pack_treelet_tables(
            bvh_nodes, tri_dict, max_rows=tre_rows)
    bvh = BVHArrays(
        min_x=f32(bmin[:, 0]), min_y=f32(bmin[:, 1]), min_z=f32(bmin[:, 2]),
        max_x=f32(bmax[:, 0]), max_y=f32(bmax[:, 1]), max_z=f32(bmax[:, 2]),
        tri_first=i32(node_i["tri_first"]),
        tri_count=i32(node_i["tri_count"]),
        second_child=i32(node_i["second_child"]),
        parent=i32(node_i["parent"]),
        sibling=i32(node_i["sibling"]),
    )

    cam = CameraArrays(
        position=f32(camera["position"]),
        view=f32(camera["view"]),
        up=f32(camera["up"]),
        right=f32(camera["right"]),
        pixel_length=f32(camera["pixel_length"]),
        lens_radius=f32(camera["lens_radius"]),
        focal_distance=f32(camera["focal_distance"]),
    )
    return SceneArrays(
        geoms=geoms, materials=materials, bvh=bvh, camera=cam,
        bvh_packed_f=f32(packed_f), bvh_packed_i=i32(packed_i),
        tris_packed=f32(packed_t),
        treelet_f=f32(treelet_f), treelet_i=i32(treelet_i),
        treelet_super=f32(treelet_super),
        tre_rows=int(tre_rows or MAX_TRE_ROWS),
        mesh_roots=tuple(int(x.get("root_node", -1)) for x in geom_list
                         if x["type"] == MESH))
