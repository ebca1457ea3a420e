"""Inverse rendering demo: recover material albedos from a target image.

The differentiable-rendering north star (BASELINE.json config #5): render a
target with known materials, perturb them, then recover by gradient descent
through the full wavefront path tracer — every step is one jitted
value_and_grad of the pixel MSE (the gradient flows through shading,
textures and emitter radiance; sampling decisions are detached, see
integrators/pt.py).

Run (CPU or GPU; small sizes keep it under a minute on CPU):
  python examples/inverse_rendering.py [--res 24] [--iters 40]

On a multi-chip mesh the same loss runs sharded with an implicit gradient
psum — see fermat_tpu.parallel.mesh.train_step_sharded.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=24)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--lr", type=float, default=2.0)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend even when a GPU is attached")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from fermat_tpu.integrators.pt import PTOptions, render_pass
    from fermat_tpu.scene.procedural import cornell_box, cornell_camera
    from fermat_tpu.scene.view import SceneView

    res = args.res
    scene = cornell_box(light_size=2.0)
    view = SceneView.build(scene, cornell_camera())
    opts = PTOptions(max_path_length=2, rr=False)

    def render_mean(v):
        acc = 0.0
        for i in range(4):
            out = render_pass(v, opts, res, res, jnp.uint32(i))
            acc = acc + out.composited.stack()
        return acc / 4

    target = jax.lax.stop_gradient(render_mean(view))
    true_d = view.mesh.materials.diffuse
    wrong = true_d._replace(
        x=jnp.clip(true_d.x * 0.4 + 0.3, 0, 1),
        y=jnp.clip(true_d.y * 0.4 + 0.1, 0, 1),
        z=jnp.clip(true_d.z * 0.4 + 0.2, 0, 1),
    )

    @jax.jit
    def step(diffuse):
        def loss_fn(diffuse):
            mats = view.mesh.materials._replace(diffuse=diffuse)
            v = view._replace(mesh=view.mesh._replace(materials=mats))
            return jnp.mean((render_mean(v) - target) ** 2)

        return jax.value_and_grad(loss_fn)(diffuse)

    diffuse = wrong
    for it in range(args.iters):
        loss, g = step(diffuse)
        diffuse = jax.tree_util.tree_map(
            lambda p, gr: jnp.clip(p - args.lr * gr, 0.0, 1.0), diffuse, g)
        if it % 5 == 0 or it == args.iters - 1:
            err = float(jnp.mean(jnp.abs(diffuse.x - true_d.x)))
            print(f"iter {it:3d}  loss {float(loss):.5f}  "
                  f"albedo L1 err {err:.4f}", flush=True)

    err0 = float(jnp.mean(jnp.abs(wrong.x - true_d.x)))
    err1 = float(jnp.mean(jnp.abs(diffuse.x - true_d.x)))
    print(f"\nrecovered: albedo error {err0:.4f} -> {err1:.4f}")


if __name__ == "__main__":
    main()
