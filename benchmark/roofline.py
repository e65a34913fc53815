"""The least time the closest-hit work of an iteration can take on the
card, from the work alone, whatever implements it.

Per bounce, each live lane (a ray that still needs its closest hit) reads
its ray and its current closest t once (origin, direction, t: 28 bytes)
and writes its hit record once (t, normal, material: 20 bytes); and the
mesh's triangle table is read once (three corners, three corner normals
and a material: 76 bytes a triangle). No hierarchy is counted: the closest
hit needs none, so the bound stays a lower one. A closest hit has no
minimal operation count, so the bound is the bytes over the card's
bandwidth.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the full 700 W power limit
PEAK_BYTES_S = 3.35e12
RAY_BYTES = 28
HIT_BYTES = 20
TRI_BYTES = 76


def closest_hit_bytes(live_lanes: list, n_tris: int) -> float:
    """Bytes an iteration: `live_lanes` holds, for one or more iterations,
    the live lanes before each bounce (and after the last, not counted)."""
    per_iter = []
    for counts in live_lanes:
        bounces = counts[:-1]
        per_iter.append(sum(n * (RAY_BYTES + HIT_BYTES) + n_tris * TRI_BYTES
                            for n in bounces if n > 0))
    return sum(per_iter) / len(per_iter)


def closest_hit_seconds(live_lanes: list, n_tris: int) -> float:
    return closest_hit_bytes(live_lanes, n_tris) / PEAK_BYTES_S


def n_triangles(cell) -> int:
    """The configuration's triangle count, by the reference's parse."""
    from .spec import load_reference_scene
    return load_reference_scene(cell).n_tris
