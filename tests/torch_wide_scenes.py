"""Crafted 8-wide forests that pin down the tie rules of the 8-wide walk
(pathtracer_tpu_torch/ops/wide.py, csrc/wide.cu), for
tests/test_torch_wide.py (the plain walk against the JAX walk on the CPU)
and tests/test_torch_kernels.py (the kernel against the plain walk on the
card). Imports no JAX.

Every coordinate is a small dyadic number, so the slab and Moller-Trumbore
arithmetic is exact in float32, with or without FMA contraction, and two
copies of one triangle tie on t by their bits. The rays come in runs of 128
lanes that share their direction signs and the boxes they enter, so the JAX
kernel, which orders children by a 128-lane packet's summed direction and
tests a leaf for the whole packet, walks each lane as the port does.

Each scene is (wide_nodes, tris8, root, o [3, N], d [3, N], mats [N]):
scene/bvh8.py's node dicts and triangle dict, and the material that the tie
rule gives each lane (-1: a miss).
"""
import numpy as np

KEEP, DROP = 1, 2        # materials of the triangle a tie keeps / drops
NORMALS = {KEEP: (1.0, 0.0, 1.0), DROP: (0.0, 1.0, 1.0)}
RUN = 128                # lanes a run of rays
BOX = ((-1.0, -1.0, 0.5), (3.0, 3.0, 1.5))
# in the plane z = 1: every ray of a run from z = -1 along +z hits it at t 2
FLAT = ((-1.0, -1.0, 1.0), (3.0, -1.0, 1.0), (-1.0, 3.0, 1.0))
EDGE_L = ((0.0, -1.0, 1.0), (0.0, 3.0, 1.0), (-4.0, -1.0, 1.0))
EDGE_R = ((0.0, -1.0, 1.0), (4.0, -1.0, 1.0), (0.0, 3.0, 1.0))


def _groups(n_groups, placed):
    """scene/bvh8.py's triangle dict of n_groups 8-triangle groups, zero
    (degenerate, never hit) but for placed {(group, slot): (verts, mat)}."""
    n = 8 * n_groups
    tris = {k: np.zeros((n, 3), np.float32)
            for k in ("v0", "v1", "v2", "n0", "n1", "n2")}
    tris["material_id"] = np.zeros(n, np.int32)
    for (g, k), (verts, mat) in placed.items():
        row = 8 * g + k
        for key, v in zip(("v0", "v1", "v2"), verts):
            tris[key][row] = v
        for key in ("n0", "n1", "n2"):
            tris[key][row] = NORMALS[mat]
        tris["material_id"][row] = mat
    return tris


def _node(children, boxes, axis=0):
    return {"children": children,
            "boxes": [(np.array(lo, np.float32), np.array(hi, np.float32))
                      for lo, hi in boxes],
            "axis": axis}


def _run(origin_xz, direction, n=RUN):
    """A run of n rays from (x, y, z) with y on a dyadic grid in
    [-0.5, 0.75), all along `direction`."""
    y = -0.5 + np.arange(n, dtype=np.float32) / 128.0 * 1.25
    o = np.stack([np.full(n, origin_xz[0], np.float32), y,
                  np.full(n, origin_xz[1], np.float32)])
    d = np.repeat(np.array(direction, np.float32)[:, None], n, axis=1)
    return o, d


def _flat_rays(dx_signs):
    """Runs along (s * 2^-10, 0, 1) from x in [-0.75, 0.5], z = -1."""
    os_, ds = [], []
    for s in dx_signs:
        o, d = _run((0.0, -1.0), (s * 2.0 ** -10, 0.0, 1.0))
        o[0] = -0.75 + (np.arange(RUN) % 5) * 0.3125
        os_.append(o)
        ds.append(d)
    return np.concatenate(os_, axis=1), np.concatenate(ds, axis=1)


def one_group():
    """Two copies at equal t in one 8-triangle group: the lower slot wins."""
    tris = _groups(1, {(0, 2): (FLAT, KEEP), (0, 5): (FLAT, DROP)})
    o, d = _flat_rays([1.0])
    return [_node([(2, 0, 1)], [BOX])], tris, 0, o, d, np.full(RUN, KEEP)


def two_groups():
    """Two copies at equal t in the two groups of one leaf: the first
    group wins, though the second's copy sits in a lower slot."""
    tris = _groups(2, {(0, 6): (FLAT, KEEP), (1, 1): (FLAT, DROP)})
    o, d = _flat_rays([1.0])
    return [_node([(2, 0, 2)], [BOX])], tris, 0, o, d, np.full(RUN, KEEP)


def two_leaves():
    """Two copies at equal t in two leaves of one node, with the same box:
    the leaf pushed last, the nearer along the node's axis x by the sign of
    the ray's own direction, wins (slot 0 for +x, slot 1 for -x)."""
    tris = _groups(2, {(0, 3): (FLAT, KEEP), (1, 3): (FLAT, DROP)})
    o, d = _flat_rays([1.0, -1.0])
    mats = np.concatenate([np.full(RUN, KEEP), np.full(RUN, DROP)])
    return ([_node([(2, 0, 1), (2, 1, 1)], [BOX, BOX])], tris, 0, o, d,
            mats)


def shared_edge():
    """Two triangles whose boxes share the face x = 0 and which share the
    edge x = 0 of the plane z = 1. Rays along (+-1, 0, 1) leave one box and
    enter the other at t = 1, where they cross the edge: both triangles
    hit at t 1 (u or v exactly zero), and the box entered first wins. Rays
    along +z in the plane x = 0 give the slab test 0 * inf = NaN on both
    boxes, so they enter neither and miss."""
    left = ((-4.0, -1.0, 0.5), (0.0, 3.0, 1.5))
    right = ((0.0, -1.0, 0.5), (4.0, 3.0, 1.5))
    tris = _groups(2, {(0, 0): (EDGE_L, KEEP), (1, 0): (EDGE_R, DROP)})
    runs = [_run((-1.0, 0.0), (1.0, 0.0, 1.0)),
            _run((1.0, 0.0), (-1.0, 0.0, 1.0)),
            _run((0.0, -1.0), (0.0, 0.0, 1.0))]
    o = np.concatenate([r[0] for r in runs], axis=1)
    d = np.concatenate([r[1] for r in runs], axis=1)
    mats = np.concatenate([np.full(RUN, KEEP), np.full(RUN, DROP),
                           np.full(RUN, -1)])
    return ([_node([(2, 0, 1), (2, 1, 1)], [left, right])], tris, 0, o, d,
            mats)


SCENES = {"one_group": one_group, "two_groups": two_groups,
          "two_leaves": two_leaves, "shared_edge": shared_edge}
