"""Host-side math helpers (NumPy): transforms matching the reference semantics.

A copy of pathtracer_tpu/utils/math.py: the port imports nothing of the JAX
package. Reference: src/utilities.cpp:85-93 (buildTransformationMatrix),
glm column-major T * Rx * Ry * Rz * S composition with degrees input.
"""
from __future__ import annotations

import numpy as np

PI = 3.1415926535897932384626422832795028841971
TWO_PI = 6.2831853071795864769252867665590057683943
SQRT_OF_ONE_THIRD = 0.5773502691896257645091487805019574556476


def translate(t: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = t
    return m


def rotate_axis(angle_rad: float, axis: int) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    m = np.eye(4, dtype=np.float64)
    if axis == 0:
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    elif axis == 1:
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    else:
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def scale(s: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = s[0], s[1], s[2]
    return m


def build_transformation_matrix(translation, rotation_deg, scale_vec) -> np.ndarray:
    """T * Rx * Ry * Rz * S, rotation in degrees (reference utilities.cpp:85-93)."""
    t = translate(np.asarray(translation, dtype=np.float64))
    rx = rotate_axis(float(rotation_deg[0]) * PI / 180.0, 0)
    ry = rotate_axis(float(rotation_deg[1]) * PI / 180.0, 1)
    rz = rotate_axis(float(rotation_deg[2]) * PI / 180.0, 2)
    s = scale(np.asarray(scale_vec, dtype=np.float64))
    return t @ rx @ ry @ rz @ s


def inverse_transpose(m: np.ndarray) -> np.ndarray:
    """glm::inverseTranspose of the full 4x4 (reference scene.cpp:217)."""
    return np.linalg.inv(m).T


def normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v
