"""Scene data model: flat SoA tensors on one device, plus static settings.

The port of pathtracer_tpu/scene/types.py. `SceneArrays` is a dataclass of
tensors that all live on the device given to `make_scene_arrays`;
`RenderSettings` is the same frozen, hashable configuration as the JAX
package's. The packed `[rows, 128]` tables keep the JAX layouts byte for byte,
so the CUDA kernels (ops/binned.py, ops/bvh_packet.py) read exactly the tables
the Pallas kernels read, and the tests can hold one against the other.

The binned intersector's ablation forms read two more tables, built at load
as the JAX package builds them: `treelet_chunk` (the chunk gate's boxes) and
`tri_attrs` (the uv stream's gather table). The brute-force tables, the 8-wide
BVH tables and the per-triangle SoA table of the "jnp" walk are built on
request (`brute_tables` / `wide_data` / `triangle_table`, which the loader
sets for bvh_impl="jnp"); otherwise they are placeholders (the JAX package
always builds the last).
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
CHUNK_GATE_ROWS = 4       # triangle rows per chunk-gate box (treelet_chunk):
#                           the gated stream slab-tests a chunk's union box
#                           against the ray's best so far before its tests
WIDE_NODES_PER_BLOCK = 16  # wide nodes per (8, 128) table block: node j's
#                            field f at lane j*8+f, child c at row c
WIDE_GROUPS_PER_BLOCK = 6  # 8-tri groups per (8, 128) tris8 block: group g
#                            at lanes (g%6)*20..+19, triangle t at row t
WIDE_LEAF_TAG = 1 << 30    # push-stack code of a leaf: TAG + group*4 + count
MXU_TRI_TILE = 512    # triangles per brute-force tile (table padding unit)
MXU_NFEAT = 16        # per-ray feature vector [d, o, o x d, 1] padded 10->16
# the features each linear form (a, un, vn, tn) of pack_tris_mxu has a
# coefficient for; every other coefficient is zero
BRUTE_TERMS = ((0, 1, 2), (0, 1, 2, 6, 7, 8), (0, 1, 2, 6, 7, 8),
               (3, 4, 5, 9))
BRUTE_ROW = 20        # the 19 structural coefficients of a triangle + a pad


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
class TriangleArrays:
    """SoA of the BVH-ordered triangles, fully component-split for 1-D
    gathers (pathtracer_tpu/scene/types.py:502): 18 coordinate tensors [T]
    and the material id. Zero rows unless the scene was loaded for the
    "jnp" walk."""

    v0x: torch.Tensor
    v0y: torch.Tensor
    v0z: torch.Tensor
    v1x: torch.Tensor
    v1y: torch.Tensor
    v1z: torch.Tensor
    v2x: torch.Tensor
    v2y: torch.Tensor
    v2z: torch.Tensor
    n0x: torch.Tensor
    n0y: torch.Tensor
    n0z: torch.Tensor
    n1x: torch.Tensor
    n1y: torch.Tensor
    n1z: torch.Tensor
    n2x: torch.Tensor
    n2y: torch.Tensor
    n2z: torch.Tensor
    material_id: torch.Tensor  # [T] int32

    def vertex(self, name: str, idx: torch.Tensor):
        """Gather one corner or normal (name in v0..n2) as a Vec3 of [N]."""
        from ..utils.vec import Vec3
        return Vec3(getattr(self, name + "x")[idx],
                    getattr(self, name + "y")[idx],
                    getattr(self, name + "z")[idx])

    @property
    def count(self) -> int:
        return self.v0x.shape[0]


TRIANGLE_FIELDS = ("v0", "v1", "v2", "n0", "n1", "n2")


def make_triangle_arrays(tris, device) -> TriangleArrays:
    """TriangleArrays on `device` from the loader's triangle dict (None:
    the zero-row placeholder)."""
    comps = []
    for name in TRIANGLE_FIELDS:
        a = (np.zeros((0, 3), np.float32) if tris is None
             else np.array(tris[name], np.float32))
        comps.extend(torch.as_tensor(np.ascontiguousarray(a[:, c]),
                                     device=device) for c in range(3))
    mat = (np.zeros(0, np.int32) if tris is None
           else np.array(tris["material_id"], np.int32))
    return TriangleArrays(*comps, material_id=torch.as_tensor(mat,
                                                              device=device))


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
    # per-triangle SoA for the "jnp" walk; zero rows unless loaded with
    # bvh_impl="jnp"
    triangles: TriangleArrays
    # row-packed tables for the packet walk (pack_bvh_tables)
    bvh_packed_f: torch.Tensor   # [Rf, 128] f32
    bvh_packed_i: torch.Tensor   # [Ri, 128] i32
    tris_packed: torch.Tensor    # [Rt, 128] f32
    # treelet tables for the binned intersector (pack_treelet_tables)
    treelet_f: torch.Tensor      # [ceil(T/16), 128] f32 bounds
    treelet_i: torch.Tensor      # [ceil(T/32), 128] i32 row ranges
    treelet_super: torch.Tensor  # [ceil(T/16), 128] f32 per-row union bounds
    treelet_chunk: torch.Tensor  # [T_pad8, 128] f32 per-chunk gate boxes
    tri_attrs: torch.Tensor      # [Nt_pad, 16] f32 (n0, n1, n2, mat)
    # brute-force tables (pack_tris_mxu); zero rows unless loaded with
    # brute_tables=True
    tris_mxu_c: torch.Tensor     # [Tt*4*512, 16] f32 linear-form coefficients
    tris_mxu_n: torch.Tensor     # [Tt*512, 16] f32 (n0, n1, n2, mat)
    tris_brute: torch.Tensor     # [Tt*512, 20] f32 (pack_tris_brute)
    # 8-wide BVH tables (pack_wide_tables): one forest covers every mesh,
    # rooted at wide_root[0]; a one-node empty forest unless loaded with
    # wide_tables=True
    nodes8_f: torch.Tensor       # [Wb*8, 128] f32 child boxes
    nodes8_i: torch.Tensor       # [Wb*8, 128] i32 child records
    tris8: torch.Tensor          # [Gb*8, 128] f32 8-tri groups
    wide_root: torch.Tensor      # [1] i32
    nodes8_c: torch.Tensor       # [Wb*16*8, 8] i32 (pack_wide_nodes)
    # host-side statics: the rows-per-treelet bound (the JAX package carries
    # it as the shape of `treelet_rows`), the BVH root of every mesh geom,
    # whether nodes8_* / tris8 hold a built forest (not the placeholder), and
    # the triangles the brute-force kernel sweeps (pack_tris_brute)
    tre_rows: int
    mesh_roots: tuple
    wide_built: bool
    brute_tris: int

    @property
    def device(self) -> torch.device:
        return self.tris_packed.device


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static, hashable render configuration (the JAX package's)."""

    width: int
    height: int
    trace_depth: int = 8
    iterations: int = 5000
    image_name: str = "render"
    jitter: bool = True          # JITTER: Gaussian AA, sigma=0.005, clamp +-0.5
    dof: bool = True             # DOF: thin-lens, active iff lens_radius > 0
    sort_materials: bool = False  # COALESCED: material-key sort each bounce
    # STREAM_COMPACT mode: tile-granular work skipping (engine/wavefront.py
    # bounce_step_tiled); compact_tile must divide the pool
    compact: bool = False
    compact_tile: int = 16384    # lanes per skippable tile (compact mode)
    # the RNG: the PCG hash streams keyed on pixels (True), or the threefry
    # streams of jax.random, drawn by lane row (False; ops/rng.py)
    fast_rng: bool = True
    # material-table capability flags (set by the loader): BSDF branches no
    # material can take are not computed (ops/bsdf.py scatter_ray)
    any_glossy: bool = True
    any_refractive: bool = True
    depth_quirk: bool = False    # reference termination quirk (ops/bsdf.py)
    rr_start: int = 0            # Russian roulette from this depth (0 = off)
    # mesh intersector, the names of the JAX package: "binned"
    # (ops/binned.py), "pallas" (the packet walk alone, ops/bvh_packet.py),
    # "sorted" (the packet walk over coherence-sorted chunks), "wide" /
    # "wide_nosort" (the 8-wide walk, ops/wide.py, with or without that
    # sort; needs wide tables), "brute" (every triangle, ops/brute.py;
    # needs brute tables) and "jnp" (the differentiable reference walk,
    # ops/intersect.py mesh_intersect; needs the triangle table)
    bvh_impl: str = "pallas"
    look_at: tuple = (0.0, 0.0, 0.0)
    fovy_deg: float = 45.0
    geom_types: tuple = ()       # static per-geom type tuple
    tile: tuple | None = None    # tile-major lane order (tile_h, tile_w)
    # round-robin shard interleave, set to the shard count S by the sharded
    # entry points (parallel/sharding.py): shard s's contiguous lane block
    # is dealt over every S-th granule (_granule: ~1k consecutive base
    # lanes) of the image instead of one band, so shards get like work.
    # Images are the same (the RNG is keyed by pixel id; lanes_to_image
    # inverts the composed map)
    shard_interleave: int | None = None

    def pixel_map(self):
        """lane -> pixel id function: the granule round-robin over
        shard_interleave shards, then the tile map (identity when neither is
        set). Pure index math on ints, numpy arrays or tensors of
        non-negative lanes."""
        if self.tile is None:
            base = lambda lane: lane  # noqa: E731
        else:
            from ..ops.camera import tile_pixel_map
            base = tile_pixel_map(self.width, self.height, *self.tile)
        S = self.shard_interleave
        if not S or S <= 1:
            return base
        n_local = self.pixel_count // S
        # >= 32 granules a shard to average over, at most ~1k lanes a granule
        # to keep a shard's kernel blocks spatially coherent
        G = _granule(n_local, target=max(64, min(1024, n_local // 32)))

        def m(lane):
            l, s = lane % n_local, lane // n_local
            q, r = l // G, l % G
            return base((q * S + s) * G + r)

        return m

    @property
    def pixel_count(self) -> int:
        return self.width * self.height


def _granule(n_local: int, target: int = 1024) -> int:
    """The largest divisor of n_local not above `target`: the
    shard-interleave granule (800x800 over 8 shards -> 1000, 80 granules a
    shard). pathtracer_tpu/scene/types.py:675."""
    best = 1
    d = 1
    while d * d <= n_local:
        if n_local % d == 0:
            if d <= target:
                best = max(best, d)
            if n_local // d <= target:
                best = max(best, n_local // d)
        d += 1
    return best


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
      treelet_chunk [T_pad8, 128] f32: row g holds the union boxes of
          treelet g's CHUNK_GATE_ROWS-row chunks, chunk c (relative rows
          [4c, 4c + 4)) at lanes c*8 .. c*8+5 as (min xyz, max xyz); empty
          and past-the-end chunks are inverted boxes
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

    n_chunks = -(-max_rows // CHUNK_GATE_ROWS)
    assert n_chunks * 8 <= 128, (
        "treelet rows bound too large for one chunk-gate row per treelet")
    chunk = _inverted_boxes((-(-max(T, 1) // 8) * 8, 128))
    row0 = first // TRIS_PER_ROW
    nrows = -(-count // TRIS_PER_ROW)
    for g in range(T):
        for c in range(n_chunks):
            r0 = int(row0[g]) + c * CHUNK_GATE_ROWS
            r1 = min(int(row0[g]) + int(nrows[g]), r0 + CHUNK_GATE_ROWS)
            if r0 >= r1:
                break
            chunk[g, c * 8:c * 8 + 3] = row_min[r0:r1].min(axis=0)
            chunk[g, c * 8 + 3:c * 8 + 6] = row_max[r0:r1].max(axis=0)
    return packed_f, packed_i, sup, chunk


def pack_bvh_tables(nodes: dict, tris: dict):
    """Pack BVH + triangles into 128-lane rows, in the JAX layout
    (pathtracer_tpu/scene/types.py:434):
      nodes_f [ceil(Nn/16), 128] f32: per node 8 fields
          (min_x,min_y,min_z,max_x,max_y,max_z, pad, pad)
      nodes_i [ceil(Nn/32), 128] i32: per node 4 fields
          (tri_first, tri_count, sibling, parent)
      tris_f  [ceil(Nt/6), 128] f32: per tri 20 fields
          (v0, e1, e2, n0, n1, n2, material_id, pad)
      tri_attrs [ceil(Nt/6) * 6, 16] f32: per tri (n0, n1, n2, material_id)
          at columns 0..9, the uv stream's gather table (the same values as
          tris_f's fields 9..18)
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
    attrs = np.zeros((rows_t * TRIS_PER_ROW, 16), np.float32)
    attrs[:nt, 0:9] = t[:, 9:18]
    attrs[:nt, 9] = t[:, 18]
    return packed_f, packed_i, packed_t, attrs


def pack_wide_tables(wide_nodes, tris8: dict):
    """Tables of the 8-wide BVH walk (ops/wide.py), in the JAX layout
    (pathtracer_tpu/scene/types.py:310):

      nodes8_f [ceil(W/16)*8, 128] f32: wide node j of block g lives at
          rows g*8..g*8+7 (row = child slot 0..7), lanes j*8+f with
          f = (min_x, min_y, min_z, max_x, max_y, max_z, pad, pad).
          Empty child slots hold NaN boxes (every slab comparison is then
          False) and are also marked kind 0.
      nodes8_i same geometry, i32, f = (kind, a, b, axis):
          kind 0 empty / 1 internal (a = wide node idx) / 2 leaf
          (a = first 8-tri group, b = group count); axis = the node's
          child-sort axis, in every slot.
      tris8 [ceil(G/6)*8, 128] f32: 8-triangle group g lives at rows
          (g//6)*8.., row = triangle, lanes (g%6)*20 + f with the same 20
          fields as pack_bvh_tables (v0, e1, e2, n0, n1, n2, mat, pad).
          Table-tail padding triangles are all zero: determinant 0, never
          valid.
    Returns numpy arrays.
    """
    w = len(wide_nodes)
    blocks = -(-w // WIDE_NODES_PER_BLOCK)
    nf = np.full((blocks * 8, 128), np.nan, np.float32)
    ni = np.zeros((blocks * 8, 128), np.int32)
    for j, nd in enumerate(wide_nodes):
        g, k = divmod(j, WIDE_NODES_PER_BLOCK)
        base = k * 8
        for c, ((kind, a, b), (mn, mx)) in enumerate(
                zip(nd["children"], nd["boxes"])):
            nf[g * 8 + c, base:base + 3] = mn
            nf[g * 8 + c, base + 3:base + 6] = mx
            ni[g * 8 + c, base:base + 4] = (kind, a, b, nd["axis"])
        for c in range(len(nd["children"]), 8):
            ni[g * 8 + c, base + 3] = nd["axis"]

    nt = tris8["v0"].shape[0]
    assert nt % 8 == 0, "tris8 must be 8-aligned (scene/bvh8.py)"
    ngroups = nt // 8
    tblocks = -(-ngroups // WIDE_GROUPS_PER_BLOCK)
    t = np.zeros((nt, TRI_STRIDE), np.float32)
    t[:, 0:3] = tris8["v0"]
    t[:, 3:6] = tris8["v1"] - tris8["v0"]
    t[:, 6:9] = tris8["v2"] - tris8["v0"]
    t[:, 9:12] = tris8["n0"]
    t[:, 12:15] = tris8["n1"]
    t[:, 15:18] = tris8["n2"]
    t[:, 18] = tris8["material_id"].astype(np.float32)
    packed = np.zeros((tblocks * 8, 128), np.float32)
    g4 = np.zeros((tblocks * WIDE_GROUPS_PER_BLOCK, 8, TRI_STRIDE),
                  np.float32)
    g4[:ngroups] = t.reshape(ngroups, 8, TRI_STRIDE)
    g4 = g4.reshape(tblocks, WIDE_GROUPS_PER_BLOCK, 8, TRI_STRIDE)
    for gg in range(WIDE_GROUPS_PER_BLOCK):
        packed[:, gg * TRI_STRIDE:(gg + 1) * TRI_STRIDE] = (
            g4[:, gg].reshape(tblocks * 8, TRI_STRIDE))
    return nf, ni, packed


def pack_wide_nodes(nodes8_f, nodes8_i):
    """The 8-wide walk kernel's node table (csrc/wide.cu) from
    pack_wide_tables' nodes8_f / nodes8_i: [W*8, 8] int32, row node*8 +
    slot, one 32-byte record a child slot:

      words 0-5  its box (min xyz, max xyz): the float32 bits of nodes8_f;
      word 6     its push-stack code: WIDE_LEAF_TAG + a*4 + b for a leaf
                 (kind 2), else a;
      word 7     kind | axis << 2, with the node's sort axis (slot 0's
                 field) as the walk reads it: 0 (x), 1 (y), else 2 (z).

    The walk takes a leaf's first group and group count back out of word
    6, so this raises on a forest whose records the code cannot hold: a
    kind other than 0, 1 or 2, or a leaf without 0 <= a < 2^28 and
    0 <= b <= 3 (scene/bvh8.py builds b <= MAX_WIDE_GROUPS = 2). Returns a
    numpy array.
    """
    per = WIDE_NODES_PER_BLOCK

    def records(a, dtype):
        return np.ascontiguousarray(a, dtype).reshape(-1, 8, per, 8).transpose(
            0, 2, 1, 3).reshape(-1, 8, 8)
    f = records(nodes8_f, np.float32)
    kind, a, b, axis = records(nodes8_i, np.int32)[..., :4].astype(
        np.int64).transpose(2, 0, 1)
    leaf = kind == 2
    if (((kind < 0) | (kind > 2)).any()
            or (leaf & ((a < 0) | (a >= 1 << 28) | (b < 0) | (b > 3))).any()):
        raise ValueError("pack_wide_nodes: a child record the walk's leaf "
                         "code cannot hold (kind not 0/1/2, or a leaf with "
                         "a outside [0, 2^28) or b outside [0, 3])")
    ax = np.where(axis[:, :1] == 0, 0, np.where(axis[:, :1] == 1, 1, 2))
    out = np.empty(f.shape, np.int32)
    out[..., :6] = f[..., :6].view(np.int32)
    out[..., 6] = np.where(leaf, WIDE_LEAF_TAG + a * 4 + b, a)
    out[..., 7] = kind | (ax << 2)
    return out.reshape(-1, 8)


def pack_tris_mxu(tris: dict):
    """Coefficient tables of the brute-force intersector (ops/brute.py), in
    the JAX layout (pathtracer_tpu/scene/types.py:374).

    Moller-Trumbore per (ray, tri) reduces to FOUR quantities that are
    LINEAR in the 10-dim per-ray feature vector F = [d, o, o x d, 1]:
      a  = d . (e2 x e1)                       (the MT determinant)
      un = (s x d) . e2 = (o x d) . e2 - d . (e2 x v0)      (= u * a)
      vn = d . (s x e1) = -(o x d) . e1 - d . (v0 x e1)     (= v * a)
      tn = s . (e1 x e2) = o . (e1 x e2) - v0 . (e1 x e2)   (= t * a)

    Returns numpy (coeffs [Tt*4*TILE, 16] f32, attrs [Tt*TILE, 16] f32):
    per tile of TILE triangles, the a, un, vn and tn rows one block after
    another; attrs rows are (n0, n1, n2, material_id, pad). Triangles are
    padded to a TILE multiple with degenerate (a == 0) entries.
    """
    v0 = np.asarray(tris["v0"], np.float64)
    v1 = np.asarray(tris["v1"], np.float64)
    v2 = np.asarray(tris["v2"], np.float64)
    e1 = v1 - v0
    e2 = v2 - v0
    t = v0.shape[0]
    tpad = -(-t // MXU_TRI_TILE) * MXU_TRI_TILE
    n_tiles = tpad // MXU_TRI_TILE

    ca = np.zeros((tpad, MXU_NFEAT), np.float64)
    cu = np.zeros((tpad, MXU_NFEAT), np.float64)
    cv = np.zeros((tpad, MXU_NFEAT), np.float64)
    ct = np.zeros((tpad, MXU_NFEAT), np.float64)
    ca[:t, 0:3] = np.cross(e2, e1)                 # a: d coefs
    cu[:t, 0:3] = -np.cross(e2, v0)                # un: d coefs
    cu[:t, 6:9] = e2                               # un: (o x d) coefs
    cv[:t, 0:3] = -np.cross(v0, e1)                # vn: d coefs
    cv[:t, 6:9] = -e1                              # vn: (o x d) coefs
    n_geo = np.cross(e1, e2)
    ct[:t, 3:6] = n_geo                            # tn: o coefs
    ct[:t, 9] = -(v0 * n_geo).sum(axis=1)          # tn: const
    coeffs = np.stack([c.reshape(n_tiles, MXU_TRI_TILE, MXU_NFEAT)
                       for c in (ca, cu, cv, ct)], axis=1)
    coeffs = coeffs.reshape(n_tiles * 4 * MXU_TRI_TILE, MXU_NFEAT)

    attrs = np.zeros((tpad, MXU_NFEAT), np.float64)
    attrs[:t, 0:3] = np.asarray(tris["n0"], np.float64)
    attrs[:t, 3:6] = np.asarray(tris["n1"], np.float64)
    attrs[:t, 6:9] = np.asarray(tris["n2"], np.float64)
    attrs[:t, 9] = np.asarray(tris["material_id"], np.float64)
    return coeffs.astype(np.float32), attrs.astype(np.float32)


def pack_tris_brute(coeffs: np.ndarray):
    """The brute-force kernel's compact table (csrc/brute.cu) from
    pack_tris_mxu's coefficients: (table [T_pad, 20] f32, n_tris).

    Row j holds triangle j's BRUTE_TERMS coefficients, form after form in
    feature order (a 0-2 | un 0-2, 6-8 | vn 0-2, 6-8 | tn 3-5, 9), and a
    zero pad. n_tris is one past the last triangle whose `a` row is not all
    zero: a triangle with a == 0 never hits, so the kernel's sweep stops
    there, before the padding slots. Raises unless every other coefficient
    is +0.0 by its bits: the kernel drops those terms, and its results equal
    the 16-term sums bit for bit only then.
    """
    c = np.ascontiguousarray(coeffs, np.float32).reshape(
        -1, 4, MXU_TRI_TILE, MXU_NFEAT).transpose(1, 0, 2, 3).reshape(
        4, -1, MXU_NFEAT)
    zero = np.ones(c.shape, bool)
    for q, terms in enumerate(BRUTE_TERMS):
        zero[q, :, list(terms)] = False
    if (c.view(np.uint32)[zero] != 0).any():
        raise ValueError("pack_tris_brute: a coefficient outside the "
                         "structural terms is not +0.0")
    table = np.zeros((c.shape[1], BRUTE_ROW), np.float32)
    table[:, :19] = np.concatenate(
        [c[q][:, list(terms)] for q, terms in enumerate(BRUTE_TERMS)], axis=1)
    live = np.nonzero((c[0] != 0).any(axis=1))[0]
    return table, int(live[-1]) + 1 if live.size else 0


def _inverted_boxes(shape) -> np.ndarray:
    """Zero table with 8-field records whose boxes are inverted (min=+inf,
    max=-inf): a slab test against them never enters."""
    a = np.zeros(shape, np.float32).reshape(-1, 8)
    a[:, 0:3] = np.inf
    a[:, 3:6] = -np.inf
    return a.reshape(shape)


def make_scene_arrays(geom_list, material_list, bvh_nodes, bvh_tris, camera,
                      device, brute_tables: bool = False, wide_data=None,
                      tre_rows: int = None,
                      triangle_table: bool = False) -> SceneArrays:
    """Build SceneArrays on `device` from the loader's host lists/dicts
    (pathtracer_tpu/scene/types.py:698).

    brute_tables: also pack the brute-force intersector's tables; without
    them they have zero rows, so the brute intersector can reject the scene.
    wide_data: optional (wide_nodes, tris8_dict, root) from scene/bvh8.py
    concat_wide; without it a one-node forest whose slots are all empty is
    packed, and `wide_built` is False so the 8-wide walk can reject the
    scene. triangle_table: also build the per-triangle SoA table of the
    "jnp" walk; without it it has zero rows, and the walk rejects the
    scene."""
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
        treelet_chunk = _inverted_boxes((8, 128))
        tri_attrs = np.zeros((1, 16), np.float32)
        mxu_c = mxu_n = np.zeros((0, MXU_NFEAT), np.float32)
    else:
        bmin = np.asarray(bvh_nodes["bounds_min"], dtype=np.float32)
        bmax = np.asarray(bvh_nodes["bounds_max"], dtype=np.float32)
        node_i = bvh_nodes
        tri_dict = {k: np.asarray(bvh_tris[k], dtype=np.float32)
                    for k in ("v0", "v1", "v2", "n0", "n1", "n2")}
        tri_dict["material_id"] = np.asarray(bvh_tris["material_id"],
                                             dtype=np.int32)
        packed_f, packed_i, packed_t, tri_attrs = pack_bvh_tables(
            bvh_nodes, tri_dict)
        treelet_f, treelet_i, treelet_super, treelet_chunk = (
            pack_treelet_tables(
                bvh_nodes, tri_dict, max_rows=tre_rows))
        if brute_tables:
            mxu_c, mxu_n = pack_tris_mxu(tri_dict)
        else:
            mxu_c = mxu_n = np.zeros((0, MXU_NFEAT), np.float32)
    brute, brute_tris = pack_tris_brute(mxu_c)
    if wide_data is not None:
        wide_nodes, tris8_dict, wide_root_idx = wide_data
        nodes8_f, nodes8_i, tris8 = pack_wide_tables(wide_nodes, tris8_dict)
    else:
        # one node, every slot kind 0 (zeros, as the JAX package packs it)
        nodes8_f = np.zeros((8, 128), np.float32)
        nodes8_i = np.zeros((8, 128), np.int32)
        tris8 = np.zeros((8, 128), np.float32)
        wide_root_idx = 0
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
        triangles=make_triangle_arrays(
            bvh_tris if triangle_table and bvh_nodes is not None
            and len(bvh_nodes["bounds_min"]) else None, device),
        bvh_packed_f=f32(packed_f), bvh_packed_i=i32(packed_i),
        tris_packed=f32(packed_t),
        treelet_f=f32(treelet_f), treelet_i=i32(treelet_i),
        treelet_super=f32(treelet_super),
        treelet_chunk=f32(treelet_chunk), tri_attrs=f32(tri_attrs),
        tris_mxu_c=f32(mxu_c), tris_mxu_n=f32(mxu_n), tris_brute=f32(brute),
        nodes8_f=f32(nodes8_f), nodes8_i=i32(nodes8_i), tris8=f32(tris8),
        wide_root=i32([wide_root_idx]),
        nodes8_c=i32(pack_wide_nodes(nodes8_f, nodes8_i)),
        tre_rows=int(tre_rows or MAX_TRE_ROWS),
        mesh_roots=tuple(int(x.get("root_node", -1)) for x in geom_list
                         if x["type"] == MESH),
        wide_built=wide_data is not None, brute_tris=brute_tris)
