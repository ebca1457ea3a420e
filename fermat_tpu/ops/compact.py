"""Stream compaction + splat primitives — the XLA replacement for the
reference's warp-aggregated queue atomics.

Reference: cugar/basic/cuda/warp_atomics.h:99-180 (`warp_increment`) used by
PTRayQueue::warp_append (pathtracer_queues.h:69-93) to append surviving rays
to dense queues, and the atomic framebuffer splats
(per_warp_atomic_add, pathtracer_core.h:544-565).

XLA exposes no global atomics; the equivalents are:
  * `compact`     — exclusive-scan (cumsum) + scatter: mask -> dense prefix
                    of surviving lanes (the queue-append analog)
  * `expand`      — inverse mapping for reading compacted results back
  * `splat_add`   — scatter-add by target id (segment-sum; the atomic splat
                    analog; `.at[].add` is XLA's deterministic sorted scatter)

Queues stay FIXED CAPACITY: `compact` returns a dense prefix in a same-size
buffer plus the live count; downstream stages run on all lanes with
index < count masks. This keeps shapes static under jit while giving the
reference's shrinking-wavefront memory locality.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


class Compaction(NamedTuple):
    """Result of compact(): a gather map + live count.

    gather_idx[i] = source lane of compacted slot i (undefined garbage-safe
    clamp for i >= count); scatter_idx[j] = destination slot of source lane j
    (= count..n-1 positions are unused for dead lanes).
    """

    gather_idx: Array  # (n,) i32
    scatter_idx: Array  # (n,) i32
    count: Array  # () i32
    mask: Array  # (n,) bool — the original mask


def compact(mask: Array) -> Compaction:
    """Dense-prefix compaction of the set lanes (warp_append analog)."""
    n = mask.shape[0]
    m = mask.astype(jnp.int32)
    scatter_idx = jnp.cumsum(m) - m  # exclusive scan
    count = jnp.sum(m)
    # invert: gather_idx[scatter_idx[j]] = j for live j
    gather_idx = jnp.zeros(n, jnp.int32)
    src = jnp.arange(n, dtype=jnp.int32)
    gather_idx = gather_idx.at[jnp.where(mask, scatter_idx, n - 1)].max(
        jnp.where(mask, src, 0)
    )
    return Compaction(
        gather_idx=gather_idx, scatter_idx=scatter_idx.astype(jnp.int32),
        count=count, mask=mask,
    )


def gather_tree(c: Compaction, tree):
    """Apply the compaction to every (n,)-leading-dim leaf of a pytree."""
    return jax.tree_util.tree_map(lambda a: a[c.gather_idx], tree)


def scatter_tree(c: Compaction, compacted_tree, original_tree):
    """Write compacted results back to their source lanes (dead lanes keep
    their original values)."""

    def put(comp, orig):
        vals = comp[c.scatter_idx]
        return jnp.where(
            c.mask.reshape(c.mask.shape + (1,) * (orig.ndim - 1)), vals, orig
        )

    return jax.tree_util.tree_map(put, compacted_tree, original_tree)


def splat_add(image: Array, pixel: Array, values: Array, enabled: Array = None) -> Array:
    """Scatter-add splats (the atomic ConnectionsSink<true> analog).

    image (P, C); pixel (n,); values (n, C).
    """
    if enabled is not None:
        values = jnp.where(enabled[:, None], values, 0.0)
        pixel = jnp.where(enabled, pixel, 0)
    return image.at[pixel].add(values, mode="drop")
