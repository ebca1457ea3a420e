"""Row gathers from small tables.

Shading reads whole rows of small tables (materials, lights, texture
metadata) by per-lane indices. `gather_rows` is the plain gather
`table[idx]`: one gather that moves K contiguous floats per index.

`one_hot_matmul_gather` computes the same rows as a one-hot matmul at
HIGHEST precision (exact: each output is one table entry times 1.0). It
suits hardware whose gathers are slow against its matmul unit; on a GPU it
writes the (N, Rp) one-hot to device memory (11.7 GB at N = 1.43M,
Rp = 2048), runs a float32 matmul off the tensor cores, and loses to
`table[idx]` at every measured shape (PERF.md, Findings). It stays as the
foil `chip_smoke.py` times the plain gather against.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def one_hot_matmul_gather(table: Array, idx: Array) -> Array:
    """table (R, K) f32, idx (N,) int in [0, R) -> (N, K) via one-hot matmul."""
    r, k = table.shape
    rp = -(-r // 128) * 128
    tp = jnp.pad(table, ((0, rp - r), (0, 0)))
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, rp), 1)
    onehot = (idx.astype(jnp.int32)[:, None] == iota).astype(table.dtype)
    return jnp.dot(onehot, tp, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def gather_rows(table: Array, idx: Array) -> Array:
    """(R, K) rows by (N,) indices -> (N, K).

    A lane whose index lies outside [0, R) (a miss, tri = -1) reads some
    row of the table, as JAX indexing does; callers mask such lanes."""
    return table[idx]
