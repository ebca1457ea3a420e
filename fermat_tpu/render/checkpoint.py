"""Checkpoint / resume for progressive rendering.

Reference analog: the reference's only resume story is `-save-intermediate`
pow-2 TGA snapshots (main.cu:171-181) — accumulation state is one
framebuffer, so resume = reload fb + instance (SURVEY.md §5). This build
makes that a first-class feature (preemptible machines): the full
accumulation state (framebuffer pytree + pass counter + MCMC chain state if
any) round-trips through a single .npz.

Format: flattened pytree leaves keyed by index + a treedef repr guard.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np

from fermat_tpu.render.framebuffer import Framebuffer


def save_checkpoint(path: str, ctx) -> None:
    """Snapshot a RenderingContext's accumulation state."""
    state = {
        "fb": ctx.fb,
        "renderer_state": ctx.renderer_state,
    }
    leaves, treedef = jax.tree_util.tree_flatten(state)
    payload = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    payload["instance"] = np.asarray(ctx.instance)
    payload["treedef"] = np.asarray(str(treedef))
    payload["renderer"] = np.asarray(ctx.renderer)
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str, ctx) -> None:
    """Restore accumulation state into a freshly-created context (must match
    resolution/renderer of the saved run)."""
    data = np.load(path, allow_pickle=False)
    saved_renderer = str(data["renderer"])
    if saved_renderer != ctx.renderer:
        raise ValueError(
            f"checkpoint renderer {saved_renderer!r} != context {ctx.renderer!r}"
        )
    if ctx._pass_fn is None:
        ctx._build_pass()  # materializes renderer_state structure for MCMC
    state = {"fb": ctx.fb, "renderer_state": ctx.renderer_state}
    leaves, treedef = jax.tree_util.tree_flatten(state)
    if str(treedef) != str(data["treedef"]):
        raise ValueError("checkpoint state structure mismatch")
    new_leaves = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for old, new in zip(leaves, new_leaves):
        if np.shape(old) != np.shape(new):
            raise ValueError(
                f"checkpoint leaf shape mismatch: {np.shape(new)} vs {np.shape(old)}"
            )
    state = jax.tree_util.tree_unflatten(treedef, new_leaves)
    ctx.fb = state["fb"]
    ctx.renderer_state = state["renderer_state"]
    ctx.instance = int(data["instance"])
