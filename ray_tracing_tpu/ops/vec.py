"""Vec3 — struct-of-arrays 3-vectors.

Why not (..., 3) arrays? Vec3 keeps each component as its own (...,) array
so the batch (pixels) is the only axis: every op is a full-width
elementwise op over pixels, and inside the megakernel a pixel's x, y and z
sit in registers of the same thread. This is the framework's equivalent of
the reference's Vector3 (src/vector.h:32-36) — transposed for the
hardware.

Vec3 is a pytree, so it passes through jit/scan/vmap/grad transparently.
Arithmetic operators are componentwise; scalar broadcasting follows jnp.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

NORMALIZE_EPS = 1e-5  # src/vector.c:35 (EPSILON)
ZERO_EPS = 1e-4       # src/vector.c:79 (iszerof)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Vec3:
    x: Any
    y: Any
    z: Any

    # -- construction ------------------------------------------------------

    @staticmethod
    def of(x, y, z, dtype=jnp.float32) -> "Vec3":
        return Vec3(jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype))

    @staticmethod
    def from_array(a) -> "Vec3":
        """(..., 3) -> Vec3 of (...,) components."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def splat(s) -> "Vec3":
        """Scalar or 3-sequence -> Vec3 (vec_from_scalar, src/vector.c:69-72)."""
        if hasattr(s, "__len__"):
            return Vec3.of(s[0], s[1], s[2])
        s = jnp.asarray(s, jnp.float32)
        return Vec3(s, s, s)

    @staticmethod
    def zeros(shape=(), dtype=jnp.float32) -> "Vec3":
        z = jnp.zeros(shape, dtype)
        return Vec3(z, z, z)

    @staticmethod
    def full(shape, fill, dtype=jnp.float32) -> "Vec3":
        c = jnp.full(shape, fill, dtype)
        return Vec3(c, c, c)

    def to_array(self):
        """Vec3 -> (..., 3). Only for host IO / final image assembly."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # -- algebra -----------------------------------------------------------

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

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

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self):
        return self.dot(self)

    def norm(self):
        return jnp.sqrt(self.norm2())

    def normalize(self, eps: float = NORMALIZE_EPS) -> "Vec3":
        """Safe normalize matching src/vector.c:129-138 (returns the vector
        unchanged when ||v|| < eps); NaN-free gradients via the where-trick."""
        n = self.norm()
        small = n < eps
        inv = 1.0 / jnp.where(small, jnp.ones_like(n), n)
        scaled = self * inv
        return Vec3.where(small, self, scaled)

    def reflect(self, n: "Vec3") -> "Vec3":
        """Mirror about the plane with normal n: d - 2*dot(n,d)*n."""
        return self - n * (2.0 * n.dot(self))

    def avg(self):
        """Mean of components (src/vector.c:89-92)."""
        return (self.x + self.y + self.z) / 3.0

    def min_component(self):
        return jnp.minimum(self.x, jnp.minimum(self.y, self.z))

    def max_component(self):
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def abs(self) -> "Vec3":
        return Vec3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    def clip(self, lo, hi) -> "Vec3":
        return Vec3(
            jnp.clip(self.x, lo, hi), jnp.clip(self.y, lo, hi), jnp.clip(self.z, lo, hi)
        )

    def is_zero(self, eps: float = ZERO_EPS):
        """All components within (-eps, eps) (src/vector.c:79-87)."""
        return (jnp.abs(self.x) < eps) & (jnp.abs(self.y) < eps) & (jnp.abs(self.z) < eps)

    # -- selection / broadcasting -------------------------------------------

    @staticmethod
    def where(mask, a: "Vec3", b: "Vec3") -> "Vec3":
        """Componentwise select; mask has the batch shape (no trailing 3)."""
        return Vec3(
            jnp.where(mask, a.x, b.x),
            jnp.where(mask, a.y, b.y),
            jnp.where(mask, a.z, b.z),
        )

    @staticmethod
    def where_c(mask: "Vec3", a: "Vec3", b: "Vec3") -> "Vec3":
        """Select with a per-component mask (a Vec3 of booleans)."""
        return Vec3(
            jnp.where(mask.x, a.x, b.x),
            jnp.where(mask.y, a.y, b.y),
            jnp.where(mask.z, a.z, b.z),
        )

    def broadcast_to(self, shape) -> "Vec3":
        return Vec3(
            jnp.broadcast_to(self.x, shape),
            jnp.broadcast_to(self.y, shape),
            jnp.broadcast_to(self.z, shape),
        )

    @property
    def shape(self):
        return jnp.shape(self.x)

    @property
    def dtype(self):
        return jnp.result_type(self.x)

    def __getitem__(self, idx) -> "Vec3":
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))


def fresnel_schlick(cos_theta, f0: Vec3) -> Vec3:
    """F = f0 + (1 - f0) * (1 - cos)^5 (src/main.c:126-129)."""
    p = (1.0 - cos_theta) ** 5
    return f0 + (1.0 - f0) * p
