"""Component-wise 3-vector SoA over torch tensors.

The port of pathtracer_tpu/utils/vec.py. Every per-ray quantity is a `Vec3`
of three [N] tensors, as in the JAX package, so each function of the port
takes and returns the same layout as its JAX counterpart and the tests compare
like with like. Each operation is a plain elementwise torch op; the
expression order of every formula follows the JAX package's, so float results
agree up to the rounding of transcendentals.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # --- arithmetic -------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return Vec3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # --- geometry ---------------------------------------------------------
    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self) -> torch.Tensor:
        return self.dot(self)

    def normalize(self) -> "Vec3":
        # tiny clamp: zero vectors (masked lanes) stay finite
        inv = torch.rsqrt(torch.clamp(self.length_sq(), min=1e-30))
        return self * inv

    # --- elementwise helpers ----------------------------------------------
    def min_component(self) -> torch.Tensor:
        return torch.minimum(torch.minimum(self.x, self.y), self.z)

    def max_component(self) -> torch.Tensor:
        return torch.maximum(torch.maximum(self.x, self.y), self.z)

    @staticmethod
    def where(cond, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(torch.where(cond, a.x, b.x),
                    torch.where(cond, a.y, b.y),
                    torch.where(cond, a.z, b.z))

    @staticmethod
    def minimum(a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(torch.minimum(a.x, b.x), torch.minimum(a.y, b.y),
                    torch.minimum(a.z, b.z))

    @staticmethod
    def maximum(a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(torch.maximum(a.x, b.x), torch.maximum(a.y, b.y),
                    torch.maximum(a.z, b.z))

    @staticmethod
    def zeros(n: int, device) -> "Vec3":
        return Vec3(torch.zeros(n, device=device),
                    torch.zeros(n, device=device),
                    torch.zeros(n, device=device))

    # --- conversion ---------------------------------------------------------
    def to_array(self) -> torch.Tensor:
        """Vec3 of [...] -> [..., 3]."""
        return torch.stack([self.x, self.y, self.z], dim=-1)


def mat4_apply(m: torch.Tensor, v: Vec3, w: float) -> Vec3:
    """(m @ [v, w]).xyz with the matrix entries as 0-d tensors (no matmul),
    in the JAX package's expression order."""
    return Vec3(
        m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z + w * m[0, 3],
        m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z + w * m[1, 3],
        m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z + w * m[2, 3],
    )
