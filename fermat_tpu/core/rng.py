"""Counter-based RNG and tiled low-discrepancy sequences.

Reference analogs:
  * cugar/sampling/lfsr.h (LFSRGeneratorMatrix MCQMC streams) and
    cugar/sampling/random.h — replaced by stateless integer-hash
    counter RNG (PCG/lowbias mixes), which is the idiomatic JAX design:
    no state to thread, every lane derives its stream from (pixel, dim, frame).
  * src/tiled_sequence.h:40-140 — per-pixel N-dim sequences built as a shared
    per-frame base QMC point + per-pixel Cranley-Patterson rotation from tiled
    shift tables. Here the base point is the Sobol (0,2) sequence and the
    per-pixel decorrelation is hash-based Owen (nested uniform) scrambling,
    which strictly dominates CP rotation in quality at the same cost profile.

All ops are uint32 bit math — they vectorize across lanes.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array

_U32 = jnp.uint32
_INV_2_32 = 2.3283064365386963e-10  # 2^-32 (python float: pallas kernels must not capture traced constants)


def _u32(x) -> Array:
    return jnp.asarray(x).astype(_U32)


def hash_u32(x: Array) -> Array:
    """lowbias32 hash (Wellons) — a high quality 32-bit mixer."""
    x = _u32(x)
    x ^= x >> 16
    x *= _U32(0x7FEB352D)
    x ^= x >> 15
    x *= _U32(0x846CA68B)
    x ^= x >> 16
    return x


def hash_combine(a: Array, b: Array) -> Array:
    """Combine two hashes (boost-style golden-ratio mix)."""
    a = _u32(a)
    b = _u32(b)
    return hash_u32(a ^ (b + _U32(0x9E3779B9) + (a << 6) + (a >> 2)))


def pcg_2d(a: Array, b: Array) -> Tuple[Array, Array]:
    """pcg2d (Jarzynski & Olano 2020): two correlated-input, decorrelated-output words."""
    v0, v1 = _u32(a), _u32(b)
    v0 = v0 * _U32(1664525) + _U32(1013904223)
    v1 = v1 * _U32(1664525) + _U32(1013904223)
    v0 += v1 * _U32(1664525)
    v1 += v0 * _U32(1664525)
    v0 ^= v0 >> 16
    v1 ^= v1 >> 16
    v0 += v1 * _U32(1664525)
    v1 += v0 * _U32(1664525)
    v0 ^= v0 >> 16
    v1 ^= v1 >> 16
    return v0, v1


def uniform_from_bits(bits: Array) -> Array:
    """uint32 -> float32 in strict [0, 1).

    Split into two 16-bit halves before converting: some Pallas backends
    have no uint32->float32 lowering, and the halves route through the
    int32->float32 path every backend supports. hi*2^16 is exact in f32 and the
    single rounding of the sum matches a direct round-to-nearest
    conversion, so the conversion is BIT-IDENTICAL to
    bits.astype(float32). Bits >= 0xFFFFFF80 would then round to
    exactly 1.0 (P = 2^-25 per draw), which breaks downstream samplers
    that assume u < 1 (CDF inversion index math, sqrt(1-u) frames), so
    the result is clamped to the largest f32 below 1.
    """
    hi = (bits >> 16).astype(jnp.int32).astype(jnp.float32)
    lo = (bits & jnp.uint32(0xFFFF)).astype(jnp.int32).astype(jnp.float32)
    u = (hi * 65536.0 + lo) * _INV_2_32
    return jnp.minimum(u, 0.99999994)  # nextafter(1, 0) in f32


def uniform(key: Array, counter: Array) -> Array:
    """One uniform float from (key, counter)."""
    return uniform_from_bits(hash_combine(key, counter))


# ---------------------------------------------------------------------------
# Sobol (0,2) sequence with hash-based Owen scrambling
# ---------------------------------------------------------------------------

def reverse_bits32(x: Array) -> Array:
    x = _u32(x)
    x = ((x & _U32(0x55555555)) << 1) | ((x & _U32(0xAAAAAAAA)) >> 1)
    x = ((x & _U32(0x33333333)) << 2) | ((x & _U32(0xCCCCCCCC)) >> 2)
    x = ((x & _U32(0x0F0F0F0F)) << 4) | ((x & _U32(0xF0F0F0F0)) >> 4)
    x = ((x & _U32(0x00FF00FF)) << 8) | ((x & _U32(0xFF00FF00)) >> 8)
    return (x << 16) | (x >> 16)


def _laine_karras(x: Array, seed: Array) -> Array:
    """Laine-Karras hash permutation: valid Owen scramble in reversed-bit space."""
    x = _u32(x)
    x += _u32(seed)
    x ^= x * _U32(0x6C50B47C)
    x ^= x * _U32(0xB82F1E52)
    x ^= x * _U32(0xC7AFE638)
    x ^= x * _U32(0x8D22F6E6)
    return x


def owen_scramble(x: Array, seed: Array) -> Array:
    """Nested uniform (Owen) scramble of a [0,1)-as-u32 sample (Burley 2020)."""
    x = reverse_bits32(x)
    x = _laine_karras(x, seed)
    return reverse_bits32(x)


def sobol02_u32(index: Array) -> Tuple[Array, Array]:
    """Integer Sobol (0,2) pair at `index` (unscrambled), as u32 fractions.

    Dim 0 is the van der Corput sequence (bit reversal); dim 1 is the second
    Sobol dimension computed from its direction numbers with an unrolled
    32-step XOR ladder (static Python loop — fine under jit).
    """
    i = _u32(index)
    d0 = reverse_bits32(i)
    # Sobol dim-2 direction numbers v_k generated by x_{k+1} = x_k ^ (x_k >> 1)
    d1 = jnp.zeros_like(i)
    v = _U32(1 << 31)
    for _ in range(32):
        d1 = jnp.where((i & _U32(1)) != 0, d1 ^ v, d1)
        i = i >> 1
        v = v ^ (v >> 1)
    return d0, d1


class TiledSequence(NamedTuple):
    """Per-pixel decorrelated QMC sampler (src/tiled_sequence.h analog).

    `seed` changes per render restart; `instance` is the progressive pass
    index (the reference's `set_instance`, tiled_sequence.cu:64-110).
    Dimensions are consumed per (bounce, purpose) exactly like the
    reference's 72-dim setup (renderer.cu:949-953).
    """

    seed: Array  # u32 scalar
    instance: Array  # i32/u32 scalar — progressive pass

    @staticmethod
    def create(seed: int = 0, instance: int = 0) -> "TiledSequence":
        return TiledSequence(_u32(seed), _u32(instance))

    def set_instance(self, instance) -> "TiledSequence":
        return self._replace(instance=_u32(instance))

    def sample_2d(self, pixel: Array, dim: Array) -> Tuple[Array, Array]:
        """Two decorrelated QMC uniforms for each pixel at dimension `dim`.

        Base point: Sobol (0,2) at a per-pixel Owen-shuffled index (so pixels
        walk different permutations of the sequence); output scrambled with a
        per-(pixel, dim) Owen scramble.
        """
        pix = _u32(pixel)
        d = _u32(dim)
        # per-pixel shuffled index in the sequence
        idx_seed = hash_combine(self.seed, hash_combine(pix, d >> 1))
        index = owen_scramble(_u32(self.instance), idx_seed)
        s0, s1 = sobol02_u32(index)
        k0 = hash_combine(idx_seed, _U32(0x68BC21EB))
        k1 = hash_combine(idx_seed, _U32(0x02E5BE93))
        u0 = uniform_from_bits(owen_scramble(s0, k0))
        u1 = uniform_from_bits(owen_scramble(s1, k1))
        return u0, u1

    def sample_1d(self, pixel: Array, dim: Array) -> Array:
        return self.sample_2d(pixel, dim)[0]

    def sample_3d(self, pixel: Array, dim: Array):
        u0, u1 = self.sample_2d(pixel, dim)
        # third dimension from a plain scrambled counter (padded sequence)
        k = hash_combine(self.seed, hash_combine(_u32(pixel), _u32(dim) + _U32(2)))
        u2 = uniform_from_bits(hash_combine(k, _u32(self.instance)))
        return u0, u1, u2


_BLUENOISE_CACHE = None


def _bluenoise_table():
    """(4096, 2) f32 flat 64x64x2 blue-noise shift table (module cache).

    Generated by tools/gen_bluenoise.py (void-and-cluster, seeds 17/41) —
    the from-scratch analog of the reference's binary shift-table assets
    (src/tiled_sampling.h:287,312 + vs/fermat/samples-*.dat)."""
    global _BLUENOISE_CACHE
    if _BLUENOISE_CACHE is None:
        import os

        import numpy as np

        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", "bluenoise64.npz")
        shift = np.load(path)["shift"].astype(np.float32)  # (64, 64, 2)
        _BLUENOISE_CACHE = jnp.asarray(shift.reshape(64 * 64, 2))
    return _BLUENOISE_CACHE


class BlueNoiseSequence(NamedTuple):
    """Blue-noise-dithered QMC sampler (tiled_sampling.h:287-312 analog).

    Every pixel evaluates the SAME Owen-scrambled Sobol point per
    (instance, dim-pair), Cranley-Patterson-shifted by a per-pixel value
    from a tiled 64x64 void-and-cluster table (Georgiev & Fajardo
    dithered sampling). Neighboring pixels get strongly negatively
    correlated sample offsets, pushing estimator error to high image
    frequencies at equal spp; per-pixel convergence keeps the shifted
    sequence's QMC behavior. Dim pairs decorrelate via hashed toroidal
    tile offsets. Unbiased: the torus shift is measure-preserving.
    """

    seed: Array  # u32 scalar
    instance: Array  # u32 scalar — progressive pass
    res_x: int  # static: pixel id -> (x, y)

    @staticmethod
    def create(seed: int = 0, instance: int = 0,
               res_x: int = 1) -> "BlueNoiseSequence":
        return BlueNoiseSequence(_u32(seed), _u32(instance), res_x)

    def set_instance(self, instance) -> "BlueNoiseSequence":
        return self._replace(instance=_u32(instance))

    def _shift(self, pixel: Array, dim: Array):
        from fermat_tpu.ops.gather import gather_rows

        pix = _u32(pixel)
        x = pix % jnp.uint32(max(self.res_x, 1))
        y = pix // jnp.uint32(max(self.res_x, 1))
        h = hash_combine(self.seed ^ _U32(0xB1E0), _u32(dim) >> 1)
        tx = (x + (h & _U32(63))) & _U32(63)
        ty = (y + ((h >> 6) & _U32(63))) & _U32(63)
        s = gather_rows(_bluenoise_table(), (ty * _U32(64) + tx))
        return s[:, 0], s[:, 1]

    def sample_2d(self, pixel: Array, dim: Array) -> Tuple[Array, Array]:
        d = _u32(dim)
        # shared per-(seed, dim-pair) shuffled index into the sequence
        idx_seed = hash_combine(self.seed, d >> 1)
        index = owen_scramble(_u32(self.instance), idx_seed)
        s0, s1 = sobol02_u32(index)
        k0 = hash_combine(idx_seed, _U32(0x68BC21EB))
        k1 = hash_combine(idx_seed, _U32(0x02E5BE93))
        b0 = uniform_from_bits(owen_scramble(s0, k0))
        b1 = uniform_from_bits(owen_scramble(s1, k1))
        sx, sy = self._shift(pixel, dim)
        u0 = b0 + sx
        u1 = b1 + sy
        u0 = jnp.minimum(jnp.where(u0 >= 1.0, u0 - 1.0, u0), 0.99999994)
        u1 = jnp.minimum(jnp.where(u1 >= 1.0, u1 - 1.0, u1), 0.99999994)
        return u0, u1

    def sample_1d(self, pixel: Array, dim: Array) -> Array:
        return self.sample_2d(pixel, dim)[0]

    def sample_3d(self, pixel: Array, dim: Array):
        u0, u1 = self.sample_2d(pixel, dim)
        k = hash_combine(self.seed,
                         hash_combine(_u32(pixel), _u32(dim) + _U32(2)))
        u2 = uniform_from_bits(hash_combine(k, _u32(self.instance)))
        return u0, u1, u2


class WhiteSequence(NamedTuple):
    """Pure counter-hash sampler — the cheap fallback (LFSRRandomStream analog)."""

    seed: Array
    instance: Array

    @staticmethod
    def create(seed: int = 0, instance: int = 0) -> "WhiteSequence":
        return WhiteSequence(_u32(seed), _u32(instance))

    def set_instance(self, instance) -> "WhiteSequence":
        return self._replace(instance=_u32(instance))

    def sample_2d(self, pixel: Array, dim: Array) -> Tuple[Array, Array]:
        k = hash_combine(self.seed, hash_combine(_u32(pixel), _u32(dim)))
        a, b = pcg_2d(k, _u32(self.instance))
        return uniform_from_bits(a), uniform_from_bits(b)

    def sample_1d(self, pixel: Array, dim: Array) -> Array:
        return self.sample_2d(pixel, dim)[0]

    def sample_3d(self, pixel: Array, dim: Array):
        u0, u1 = self.sample_2d(pixel, dim)
        u2 = self.sample_1d(pixel, _u32(dim) + _U32(2))
        return u0, u1, u2
