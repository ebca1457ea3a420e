"""Vector math on structure-of-arrays Vec3.

Reference analog: cugar/linalg/vector.h (Vector<float,3> AoS) — but this
build deliberately uses SoA: a Vec3 is three flat (N,)-shaped arrays so that
every component op vectorizes across rays with unit-stride access.

Also provides: orthonormal basis construction (cugar/linalg matrix utils +
src/vertex.h differential geometry), reflect/refract (cugar/bsdf/refraction.h),
and the 15-bit octahedral normal mapping (cugar/spherical/mappings.h,
src/framebuffer.h:84-113 GBuffer normal packing).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

Array = jax.Array
Scalar = Union[Array, float]


class Vec3(NamedTuple):
    """SoA 3-vector: three same-shaped arrays (or scalars)."""

    x: Array
    y: Array
    z: Array

    # -- arithmetic -------------------------------------------------------
    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s) -> "Vec3":
        if isinstance(s, Vec3):
            return Vec3(self.x * s.x, self.y * s.y, self.z * s.z)
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __truediv__(self, s) -> "Vec3":
        if isinstance(s, Vec3):
            return Vec3(self.x / s.x, self.y / s.y, self.z / s.z)
        return Vec3(self.x / s, self.y / s, self.z / s)

    # -- utilities --------------------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.x)

    def stack(self) -> Array:
        """To AoS (..., 3) — host/IO boundary only, not for kernels."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @staticmethod
    def from_stacked(a: Array) -> "Vec3":
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full(shape, v0: float, v1: float, v2: float, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.full(shape, v0, dtype),
            jnp.full(shape, v1, dtype),
            jnp.full(shape, v2, dtype),
        )

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "Vec3":
        z = jnp.zeros(shape, dtype)
        return Vec3(z, z, z)

    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))

    def gather(self, idx: Array) -> "Vec3":
        """Index all three components: v.gather(i) == v[i] componentwise."""
        return Vec3(self.x[idx], self.y[idx], self.z[idx])


def vec3(x, y=None, z=None) -> Vec3:
    if y is None:
        y = x
        z = x
    return Vec3(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32), jnp.asarray(z, jnp.float32))


def dot(a: Vec3, b: Vec3) -> Array:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def norm(a: Vec3) -> Array:
    return jnp.sqrt(dot(a, a))


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    inv = jax.lax.rsqrt(jnp.maximum(dot(a, a), eps))
    return a * inv


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a + (b - a) * t


def where(m: Array, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.where(m, a.x, b.x), jnp.where(m, a.y, b.y), jnp.where(m, a.z, b.z))


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """Mirror direction; i points *away* from the surface (w_i convention).

    Reference: cugar/bsdf/differential_geometry.h / ggx_smith.h mirror terms.
    """
    return n * (2.0 * dot(i, n)) - i


def refract(i: Vec3, n: Vec3, eta: Scalar):
    """Refract w_i about n with relative IoR eta = n_i/n_t.

    Returns (dir, total_internal_reflection_mask).
    Reference: cugar/bsdf/refraction.h.
    """
    cos_i = dot(i, n)
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    d = (n * cos_i - i) * eta - n * cos_t
    return normalize(d), tir


def orthonormal_basis(n: Vec3):
    """Build (t, b) orthonormal to n — branchless Frisvad/Duff construction.

    Reference analog: cugar pack_vector / vertex.h local frames.
    """
    s = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    bt = Vec3(b, s + n.y * n.y * a, -n.y)
    return t, bt


def to_local(v: Vec3, t: Vec3, b: Vec3, n: Vec3) -> Vec3:
    return Vec3(dot(v, t), dot(v, b), dot(v, n))


def to_world(v: Vec3, t: Vec3, b: Vec3, n: Vec3) -> Vec3:
    return Vec3(
        v.x * t.x + v.y * b.x + v.z * n.x,
        v.x * t.y + v.y * b.y + v.z * n.y,
        v.x * t.z + v.y * b.z + v.z * n.z,
    )


# ---------------------------------------------------------------------------
# Octahedral unit-vector mapping (normal compression).
# Reference: cugar/spherical/mappings.h; 15-bit packing used by the G-buffer
# at src/framebuffer.h:84-113.
# ---------------------------------------------------------------------------

def oct_encode(n: Vec3):
    """Unit vector -> octahedral (u, v) in [-1, 1]^2."""
    inv_l1 = 1.0 / (jnp.abs(n.x) + jnp.abs(n.y) + jnp.abs(n.z) + 1e-20)
    u = n.x * inv_l1
    v = n.y * inv_l1
    # fold the lower hemisphere
    uf = (1.0 - jnp.abs(v)) * jnp.sign(jnp.where(u == 0.0, 1.0, u))
    vf = (1.0 - jnp.abs(u)) * jnp.sign(jnp.where(v == 0.0, 1.0, v))
    return jnp.where(n.z < 0.0, uf, u), jnp.where(n.z < 0.0, vf, v)


def oct_decode(u: Array, v: Array) -> Vec3:
    z = 1.0 - jnp.abs(u) - jnp.abs(v)
    uf = (1.0 - jnp.abs(v)) * jnp.sign(jnp.where(u == 0.0, 1.0, u))
    vf = (1.0 - jnp.abs(u)) * jnp.sign(jnp.where(v == 0.0, 1.0, v))
    x = jnp.where(z < 0.0, uf, u)
    y = jnp.where(z < 0.0, vf, v)
    return normalize(Vec3(x, y, z))


def oct_pack16(n: Vec3) -> Array:
    """Pack a unit normal into 16 bits (8+8), cf. GBuffer 15-bit packing."""
    u, v = oct_encode(n)
    qu = jnp.clip(jnp.round((u * 0.5 + 0.5) * 255.0), 0, 255).astype(jnp.uint32)
    qv = jnp.clip(jnp.round((v * 0.5 + 0.5) * 255.0), 0, 255).astype(jnp.uint32)
    return qu | (qv << 8)


def oct_unpack16(p: Array) -> Vec3:
    u = ((p & 0xFF).astype(jnp.float32) / 255.0) * 2.0 - 1.0
    v = (((p >> 8) & 0xFF).astype(jnp.float32) / 255.0) * 2.0 - 1.0
    return oct_decode(u, v)


# ---------------------------------------------------------------------------
# Misc scalar helpers
# ---------------------------------------------------------------------------

def sqr(x):
    return x * x


def luminance(r, g, b):
    """Rec.709 luminance — matches cugar color usage in MLT seeding."""
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def safe_rcp(x, eps: float = 1e-12):
    return jnp.where(jnp.abs(x) > eps, 1.0 / jnp.where(jnp.abs(x) > eps, x, 1.0), 0.0)
