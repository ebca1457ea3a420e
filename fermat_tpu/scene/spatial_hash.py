"""Jittered spatial hashing of shading points.

Reference: src/spatial_hash.h:44-164 — 64-bit keys from distance-LOD
quantized position + octahedral-quantized normal, with per-sample jitter to
decorrelate cell boundaries; backed by cugar's SyncFreeHashMap
(cugar/basic/cuda/hash.h). Used by PSFPT accumulation and the clustered-RL
direct lighting tables.

Design: open-addressing-free stochastic table — key -> slot by modulo;
collisions are DETECTED (key scatter + compare) rather than resolved, and
colliding lanes fall back to their unfiltered estimate. No atomics anywhere:
inserts are scatter-writes, accumulation is scatter-add.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from fermat_tpu.core.math import Vec3, dot, oct_encode
from fermat_tpu.core.rng import hash_combine, hash_u32

Array = jax.Array
_U32 = jnp.uint32


def hash_shading_point(
    pos: Vec3,
    normal: Vec3,
    eye: Vec3,
    base_cell: float,
    table_size: int,
    jitter: Array = None,
    lod_scale: float = 64.0,
) -> Tuple[Array, Array]:
    """(slot, key) of each lane's shading point.

    Cell size grows with distance from the eye (the reference's distance-LOD
    quantization, spatial_hash.h:85-140); `jitter` in [0,1) dithers the
    quantization lattice per sample.
    """
    dx = pos.x - eye.x
    dy = pos.y - eye.y
    dz = pos.z - eye.z
    dist = jnp.sqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-12))
    # power-of-two LOD by distance
    lod = jnp.clip(jnp.round(jnp.log2(jnp.maximum(dist / lod_scale, 1e-6))), -16, 16)
    cell = base_cell * jnp.exp2(lod + 16.0) * jnp.exp2(-16.0)  # base * 2^lod
    j = 0.0 if jitter is None else jitter
    qx = jnp.floor(pos.x / cell + j).astype(jnp.int32)
    qy = jnp.floor(pos.y / cell + j).astype(jnp.int32)
    qz = jnp.floor(pos.z / cell + j).astype(jnp.int32)
    # 2-bit octahedral normal bucket per axis (16 buckets)
    u, v = oct_encode(normal)
    qn = (
        jnp.clip(((u * 0.5 + 0.5) * 4).astype(jnp.int32), 0, 3) * 4
        + jnp.clip(((v * 0.5 + 0.5) * 4).astype(jnp.int32), 0, 3)
    )
    key = hash_combine(
        hash_combine(hash_u32(qx.astype(_U32)), hash_u32(qy.astype(_U32))),
        hash_combine(hash_u32(qz.astype(_U32)),
                     hash_u32(qn.astype(_U32) ^ (lod.astype(jnp.int32).astype(_U32) << 8))),
    )
    key = jnp.maximum(key, _U32(1))  # 0 reserved for "empty"
    slot = (key % _U32(table_size)).astype(jnp.int32)
    return slot, key


class HashAccumulator(NamedTuple):
    """Persistent cell accumulator (sum + weight + owner key)."""

    sum_x: Array  # (K,)
    sum_y: Array
    sum_z: Array
    weight: Array  # (K,)
    key: Array  # (K,) u32, 0 = empty

    @staticmethod
    def create(table_size: int) -> "HashAccumulator":
        z = jnp.zeros(table_size, jnp.float32)
        return HashAccumulator(z, z, z, z, jnp.zeros(table_size, _U32))

    def decay(self, factor) -> "HashAccumulator":
        """Exponential temporal reuse (psfpt.h temporal_reuse analog)."""
        return HashAccumulator(
            self.sum_x * factor, self.sum_y * factor, self.sum_z * factor,
            self.weight * factor, self.key,
        )

    def deposit(
        self, slot: Array, key: Array, vx: Array, vy: Array, vz: Array, valid: Array
    ) -> "HashAccumulator":
        """Scatter-add deposits; claims cell ownership by key (last writer).
        Lanes whose slot is owned by a DIFFERENT key are dropped (stochastic
        collision policy; cf. SyncFreeHashMap's probing, traded for zero
        probe loops)."""
        s = jnp.where(valid, slot, 0)
        new_key = self.key.at[s].set(jnp.where(valid, key, self.key[s]))
        own = valid & (new_key[slot] == key)
        sx = self.sum_x.at[jnp.where(own, slot, 0)].add(jnp.where(own, vx, 0.0))
        sy = self.sum_y.at[jnp.where(own, slot, 0)].add(jnp.where(own, vy, 0.0))
        sz = self.sum_z.at[jnp.where(own, slot, 0)].add(jnp.where(own, vz, 0.0))
        w = self.weight.at[jnp.where(own, slot, 0)].add(jnp.where(own, 1.0, 0.0))
        return HashAccumulator(sx, sy, sz, w, new_key)

    def lookup(self, slot: Array, key: Array):
        """(mean Vec3, hit mask): cell average where the cell belongs to key."""
        ok = (self.key[slot] == key) & (self.weight[slot] > 0.0)
        inv = 1.0 / jnp.maximum(self.weight[slot], 1e-8)
        return (
            Vec3(self.sum_x[slot] * inv, self.sum_y[slot] * inv, self.sum_z[slot] * inv),
            ok,
        )
