"""Multi-chip / multi-host rendering: pixel tiles sharded over a device mesh.

No reference analog — the reference is single-GPU (renderer.cu:600-603, no
NCCL/MPI anywhere; SURVEY.md §2.3). This is the pod-scale design from
BASELINE.json's north star:

  * 1D `jax.sharding.Mesh` over all devices, axis "tiles"
  * pixel-id lanes sharded over "tiles" via shard_map; the scene pytree
    (mesh + BVH + lights + materials) is REPLICATED — rays never migrate,
    so the only collectives are the final per-pass framebuffer gather
    (implicit: the sharded output IS the framebuffer) and the gradient
    psum in the backward pass of the differentiable path (inserted by AD).
  * collectives ride ICI within a host and DCN across hosts — both handled
    by XLA from the same program.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fermat_tpu.core.math import Vec3
from fermat_tpu.integrators import pt as pt_mod
from fermat_tpu.scene.view import SceneView

Array = jax.Array

AXIS = "tiles"


def make_mesh(devices=None) -> Mesh:
    """1D mesh over all (or given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (AXIS,))


def render_pass_sharded(
    view: SceneView,
    opts: pt_mod.PTOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    mesh: Mesh,
    seed: int = 0,
):
    """One progressive pass with pixel lanes sharded over the mesh.

    Returns flat (N,) per-lane sample arrays (sharded) + the per-pass ray
    count (psum'd scalar). n_pixels must divide by the mesh size.
    """
    n = res_x * res_y
    n_dev = mesh.devices.size
    assert n % n_dev == 0, f"{n} pixels not divisible by {n_dev} devices"
    pix = jnp.arange(n, dtype=jnp.uint32)

    view_spec = jax.tree_util.tree_map(lambda _: P(), view)

    def tile_fn(v: SceneView, p: Array):
        out = pt_mod.render_pass(v, opts, res_x, res_y, instance, seed, pix=p)
        rays = jax.lax.psum(out.rays, AXIS)
        return out._replace(rays=rays)

    # prefix pytree: every _PassOutput field (incl. Vec3 subtrees) shards over
    # AXIS except the psum'd scalar ray counter
    out_specs = pt_mod._PassOutput(
        direct=P(AXIS),
        diffuse=P(AXIS),
        specular=P(AXIS),
        composited=P(AXIS),
        diffuse_albedo=P(AXIS),
        specular_albedo=P(AXIS),
        depth=P(AXIS),
        tri=P(AXIS),
        normal=P(AXIS),
        position=P(AXIS),
        uv=P(AXIS),
        material=P(AXIS),
        rays=P(),
        rays_lane=P(AXIS),
    )
    # check_vma=False: the traversal while-loops initialize their carries
    # from unvarying constants that become device-varying on the first
    # iteration; the varying-across-mesh type check would demand pcasts
    # inside tracer code that is mesh-agnostic by design.
    fn = jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(view_spec, P(AXIS)),
        out_specs=out_specs,
        check_vma=False,
    )
    return fn(view, pix)


def render_bpt_pass_sharded(
    view: SceneView,
    opts,  # bpt.BPTOptions
    res_x: int,
    res_y: int,
    instance: Array,
    mesh: Mesh,
    seed: int = 0,
):
    """One BPT pass sharded over the mesh: pixel lanes (eye subpaths AND
    their paired light subpaths) shard over AXIS; each shard scatters its
    light-tracing splats into a full-res image that the partitioner
    all-reduces — the multi-chip analog of the reference's atomic splat
    sink (bpt_impl.h:143-155; atomics become a scatter-add + one
    all-reduce over ICI).

    Implementation: GSPMD (jit over a sharded pixel domain with a
    replicated scene) rather than shard_map — the explicit
    shard_map+psum formulation of this graph lowers pathologically on
    XLA:CPU (multi-minute compiles even at 8x8; the GSPMD partitioning of
    the identical computation compiles in seconds and is bit-equal to the
    single-device pass).

    Returns (radiance Vec3 (N,) sharded over AXIS, splat (H*W, 3), rays).
    """
    from jax.sharding import NamedSharding

    from fermat_tpu.integrators import bpt as bpt_mod

    n = res_x * res_y
    n_dev = mesh.devices.size
    assert n % n_dev == 0, f"{n} pixels not divisible by {n_dev} devices"
    pix_sh = NamedSharding(mesh, P(AXIS))
    repl = NamedSharding(mesh, P())
    pix = jax.device_put(jnp.arange(n, dtype=jnp.uint32), pix_sh)
    view_r = jax.device_put(view, repl)

    @partial(jax.jit, static_argnames=())
    def f(v: SceneView, p: Array, inst: Array):
        return bpt_mod.render_pass(v, opts, res_x, res_y, inst, seed, pix=p)

    return f(view_r, pix, jnp.asarray(instance, jnp.uint32))


def render_pass_gspmd(
    view: SceneView,
    opts: pt_mod.PTOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    mesh: Mesh,
    seed: int = 0,
):
    """One PT pass partitioned by GSPMD: pixel lanes carry a NamedSharding
    over AXIS, the scene is replicated, and the partitioner inserts the
    (single) ray-count all-reduce.

    Same computation as render_pass_sharded, but jit-of-sharded-inputs
    instead of shard_map — on XLA:CPU the explicit shard_map formulation
    of the PT graph lowers pathologically (minutes at 32x32 where GSPMD
    takes seconds; same story as render_bpt_pass_sharded's docstring).
    Returns _PassOutput with
    lane arrays sharded over AXIS."""
    from jax.sharding import NamedSharding

    n = res_x * res_y
    n_dev = mesh.devices.size
    assert n % n_dev == 0, f"{n} pixels not divisible by {n_dev} devices"
    pix = jax.device_put(jnp.arange(n, dtype=jnp.uint32),
                         NamedSharding(mesh, P(AXIS)))
    view_r = jax.device_put(view, NamedSharding(mesh, P()))

    @jax.jit
    def f(v: SceneView, p: Array, inst: Array):
        return pt_mod.render_pass(v, opts, res_x, res_y, inst, seed, pix=p)

    return f(view_r, pix, jnp.asarray(instance, jnp.uint32))


def render_image_sharded(
    view: SceneView,
    opts: pt_mod.PTOptions,
    res_x: int,
    res_y: int,
    n_passes: int,
    mesh: Mesh,
    seed: int = 0,
):
    """Accumulated composited image over n_passes (jit this)."""

    def body(i, acc):
        out = render_pass_sharded(view, opts, res_x, res_y, i, mesh, seed)
        img = out.composited.stack()
        return acc + img

    acc = jnp.zeros((res_x * res_y, 3), jnp.float32)
    acc = jax.lax.fori_loop(0, n_passes, body, acc)
    return (acc / n_passes).reshape(res_y, res_x, 3)


def train_step_sharded(
    view: SceneView,
    target: Array,  # (N, 3) flat target image
    opts: pt_mod.PTOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    mesh: Mesh,
    lr: float = 0.05,
    seed: int = 0,
):
    """One differentiable inverse-rendering step: render -> MSE vs target ->
    grad w.r.t. material diffuse albedo -> SGD update.

    The gradient psum over the mesh is inserted by AD through shard_map
    (replicated params, sharded loss) and overlaps with the backward pass in
    XLA's schedule — the BASELINE.json 'gradient all-reduce over ICI' path.
    Returns (updated_view, loss).
    """

    diffuse0 = view.mesh.materials.diffuse

    def loss_fn(diffuse):
        mats = view.mesh.materials._replace(diffuse=diffuse)
        v = view._replace(mesh=view.mesh._replace(materials=mats))
        out = render_pass_sharded(v, opts, res_x, res_y, instance, mesh, seed)
        img = out.composited.stack()
        return jnp.mean((img - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(diffuse0)
    new_diffuse = jax.tree_util.tree_map(
        lambda p, g: jnp.clip(p - lr * g, 0.0, 1.0), diffuse0, grads
    )
    mats = view.mesh.materials._replace(diffuse=new_diffuse)
    return view._replace(mesh=view.mesh._replace(materials=mats)), loss
