"""8-wide BVH build: binary SAH tree collapsed to branching factor 8.

A copy of pathtracer_tpu/scene/bvh8.py (the port imports nothing of the JAX
package), built on the port's own scene/bvh.py. The 8-wide walk (ops/wide.py,
csrc/wide.cu) reads the tables that scene/types.py pack_wide_tables makes
from it.

Construction (host NumPy, runs once at scene load):
  1. build the binary SAH BVH (scene/bvh.py) with SMALL leaves (16 tris),
     then align leaf ranges to 8-triangle groups (the walk's triangle record
     unit).
  2. collapse to 8-wide: starting from each binary node, repeatedly expand
     the candidate child with the LARGEST surface area until 8 subtree
     roots or all candidates are leaves. Binary leaves become LEAF children
     (a contiguous run of 8-tri groups); everything else recurses into a
     new wide node.
  3. sort each node's children by box-center along the node's dominant
     extent axis and record the axis: the walk visits children in
     direction-sign order along it, near to far.

Multiple meshes concatenate their wide trees plus a synthetic super-root
whose children are the mesh roots, so ONE walk covers every mesh.

Child records per wide node (packed by scene/types.py pack_wide_tables):
  kind 0 = empty slot, 1 = internal (a = wide node index),
  2 = leaf (a = first 8-tri group index, b = group count).
"""
from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import numpy as np

from .bvh import align_leaves, build_bvh

WIDE_LEAF = 16        # max tris per wide leaf (binary build max_leaf)
GROUP = 8             # triangles per record group
MAX_WIDE_GROUPS = (WIDE_LEAF + GROUP - 1) // GROUP  # groups per leaf bound

KIND_EMPTY = 0
KIND_NODE = 1
KIND_LEAF = 2

MAX_DEPTH = 20  # wide-tree depth bound; the walk's push stack holds
#                 7*MAX_DEPTH+8 entries (each pop pushes <=8, pops 1), so
#                 depth is asserted at build time (tree_depth below)


def tree_depth(wide: List[dict], root: int) -> int:
    """Max internal-node depth of the wide forest reachable from `root`
    (root = depth 1). Bounds the walk's stack: a DFS holds at most 7
    siblings per level, so stack usage <= 7*depth + 8."""
    depth = {root: 1}
    todo = [root]
    best = 1
    while todo:
        j = todo.pop()
        for (k, a, _b) in wide[j]["children"]:
            if k == KIND_NODE:
                depth[a] = depth[j] + 1
                best = max(best, depth[a])
                todo.append(a)
    return best


def collapse_to_wide(nodes: Dict[str, np.ndarray],
                     group_base: int = 0) -> List[dict]:
    """Collapse a flattened binary BVH (scene/bvh.py layout: left child at
    i+1, right at second_child[i], leaf iff tri_count>0, leaf tri ranges
    8-aligned) into a list of wide-node dicts:
      {"children": [(kind, a, b)], "boxes": [(min3, max3)], "axis": int}
    `group_base` offsets leaf group indices (multi-mesh concatenation).
    """
    bmin = np.asarray(nodes["bounds_min"], np.float64)
    bmax = np.asarray(nodes["bounds_max"], np.float64)
    tri_first = nodes["tri_first"]
    tri_count = nodes["tri_count"]
    second = nodes["second_child"]
    is_leaf = tri_count > 0

    d = bmax - bmin
    sa = 2.0 * (d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2] + d[:, 1] * d[:, 2])

    wide: List[dict] = []

    def leaf_rec(i: int) -> Tuple[int, int, int]:
        assert tri_first[i] % GROUP == 0, "leaves must be 8-aligned"
        g0 = group_base + tri_first[i] // GROUP
        ng = -(-int(tri_count[i]) // GROUP)
        assert ng <= MAX_WIDE_GROUPS
        return (KIND_LEAF, g0, ng)

    def build(i: int) -> int:
        """Emit the wide node rooted at binary node i; returns its index."""
        my = len(wide)
        wide.append(None)

        # gather up to 8 subtree roots under i by splitting the largest-SA
        # internal candidate (start from i's two children; i itself only if
        # it is a leaf: a single-leaf mesh still gets a root node)
        if is_leaf[i]:
            cands = [i]
        else:
            cands = [i + 1, int(second[i])]
            while len(cands) < 8:
                internals = [c for c in cands if not is_leaf[c]]
                if not internals:
                    break
                c = max(internals, key=lambda k: sa[k])
                cands.remove(c)
                cands.extend([c + 1, int(second[c])])

        # dominant extent axis of THIS node; children sorted along it
        axis = int(np.argmax(bmax[i] - bmin[i]))
        centers = [(bmin[c, axis] + bmax[c, axis]) * 0.5 for c in cands]
        order = np.argsort(np.asarray(centers), kind="stable")
        cands = [cands[k] for k in order]

        children, boxes = [], []
        for c in cands:
            boxes.append((bmin[c].astype(np.float32),
                          bmax[c].astype(np.float32)))
            if is_leaf[c]:
                children.append(leaf_rec(c))
            else:
                children.append((KIND_NODE, build(c), 0))
        wide[my] = {"children": children, "boxes": boxes, "axis": axis}
        return my

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    root = build(0)
    sys.setrecursionlimit(old)
    assert root == 0
    return wide


def build_wide_bvh(tris: Dict[str, np.ndarray], max_leaf: int = WIDE_LEAF
                   ) -> Tuple[List[dict], Dict[str, np.ndarray]]:
    """Full wide build for ONE mesh from raw triangle SoA: its own binary
    SAH tree (small leaves) and its own 8-aligned triangle reordering,
    independent of the binned/packet tables.

    Returns (wide_nodes, reordered_tris8) with group indices local to this
    mesh (offset at concat time).
    """
    nodes, reordered = build_bvh(tris, max_leaf=max_leaf)
    nodes, reordered = align_leaves(nodes, reordered, row=GROUP)
    return collapse_to_wide(nodes), reordered


def concat_wide(meshes: List[Tuple[List[dict], Dict[str, np.ndarray]]]
                ) -> Tuple[List[dict], Dict[str, np.ndarray], int]:
    """Concatenate per-mesh wide trees into one forest with a super-root.

    Returns (wide_nodes, tris8, root_index). With one mesh the root is the
    mesh root itself; with 2..8 meshes a synthetic root node is appended
    whose children are the mesh roots (>8 meshes nest super-roots).
    """
    assert meshes
    if len(meshes) == 1:
        wide, tr = meshes[0]
        assert tree_depth(wide, 0) <= MAX_DEPTH, (
            "wide BVH deeper than the walk's stack bound")
        return wide, tr, 0

    all_nodes: List[dict] = []
    roots: List[Tuple[int, np.ndarray, np.ndarray]] = []
    tris8 = {k: [] for k in meshes[0][1]}
    group_off = 0
    for wide, tr in meshes:
        base = len(all_nodes)
        for nd in wide:
            ch = [(k, a + base if k == KIND_NODE else
                   (a + group_off if k == KIND_LEAF else a), b)
                  for (k, a, b) in nd["children"]]
            all_nodes.append({"children": ch, "boxes": nd["boxes"],
                              "axis": nd["axis"]})
        mn = np.min([b[0] for b in wide[0]["boxes"]], axis=0)
        mx = np.max([b[1] for b in wide[0]["boxes"]], axis=0)
        roots.append((base, mn, mx))
        group_off += tr["v0"].shape[0] // GROUP
        for k in tris8:
            tris8[k].append(tr[k])

    # super-root(s): group mesh roots 8 at a time until one remains
    while len(roots) > 1:
        nxt = []
        for i in range(0, len(roots), 8):
            grp = roots[i:i + 8]
            mn = np.min([g[1] for g in grp], axis=0)
            mx = np.max([g[2] for g in grp], axis=0)
            axis = int(np.argmax(mx - mn))
            grp = sorted(grp, key=lambda g: g[1][axis] + g[2][axis])
            node = {"children": [(KIND_NODE, g[0], 0) for g in grp],
                    "boxes": [(g[1].astype(np.float32),
                               g[2].astype(np.float32)) for g in grp],
                    "axis": axis}
            nxt.append((len(all_nodes), mn, mx))
            all_nodes.append(node)
        roots = nxt

    cat = {k: np.concatenate(v, axis=0) for k, v in tris8.items()}
    assert tree_depth(all_nodes, roots[0][0]) <= MAX_DEPTH, (
        "wide BVH deeper than the walk's stack bound")
    return all_nodes, cat, roots[0][0]
