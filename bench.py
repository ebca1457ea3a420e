"""Benchmark: wavefront PT throughput on the GPU, all stages in one process.

Headline metric: Mrays/s (closest + shadow rays actually traced, counted
inside the pass — masked dead lanes are NOT counted), CornellBox full-BSDF
PT at 512x512, 6 bounces, NEE+MIS. The other stages: the cornell512 train
step (AD gradient of the pixel MSE w.r.t. diffuse albedo), the big_room
and bathroom stand-in passes at 1600x896 (narrowing driver), the textured
train step, and 600k-triangle trace sweeps; on request, BPT and MLT on the
512^2 caustic stand-in (stage `integrators`). Every stage runs its one
path with tracer="auto"; a stage that fails fails the benchmark.

Each stage prints its results and wall time on one line as it finishes;
the last line is one JSON object with every result and the device.

    python bench.py                                   # the default stages
    python bench.py --stages cornell512,integrators   # a chosen subset

One process; it takes the whole card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RES = 512
N_PASSES = 16
BIG_RES = (1600, 896)
BIG_BOXES = 8300
TEXTURED_RES = (800, 448)
SWEEP_BOXES = 50_000


def _best(fn, reps=3):
    """Best wall time of `reps` calls of fn, each ending in
    block_until_ready (fn is warm)."""
    import jax

    best = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(rep + 1))
        best = min(best, time.perf_counter() - t0)
    return best


def bench_primary(view, opts) -> float:
    """Mrays/s of N_PASSES cornell512 passes in one jitted fori_loop."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators.pt import render_pass

    @jax.jit
    def batch(view, instance0):
        def body(i, carry):
            acc, rays = carry
            out = render_pass(view, opts, RES, RES, instance0 + i)
            return (acc + out.composited.x, rays + out.rays)

        return jax.lax.fori_loop(
            0, N_PASSES, body,
            (jnp.zeros(RES * RES, jnp.float32), jnp.zeros((), jnp.float32)))

    _img, rays = jax.block_until_ready(batch(view, jnp.uint32(0)))  # compile
    best = _best(lambda rep: batch(view, jnp.uint32(N_PASSES * rep)))
    return float(rays) / best / 1e6


def bench_train(view, opts) -> float:
    """Forward rays / wall time of one fwd+bwd train step at cornell512
    (detached-AD backward re-traces nothing, so forward rays are the ray
    denominator)."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators.pt import render_pass

    target = jnp.zeros((RES * RES, 3), jnp.float32)

    def loss_fn(diffuse, inst):
        mats = view.mesh.materials._replace(diffuse=diffuse)
        v = view._replace(mesh=view.mesh._replace(materials=mats))
        out = render_pass(v, opts, RES, RES, inst)
        img = out.composited.stack()
        return jnp.mean((img - target) ** 2), out.rays

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    diffuse0 = view.mesh.materials.diffuse
    (_loss, rays), _g = jax.block_until_ready(grad_fn(diffuse0, jnp.uint32(0)))
    best = _best(lambda rep: grad_fn(diffuse0, jnp.uint32(rep)))
    return float(rays) / best / 1e6


def bench_large_pass(scene: str) -> dict:
    """One 1600x896 pass of big_room or the bathroom stand-in through the
    narrowing driver (two warm-up passes compile every width bucket)."""
    import jax

    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.integrators.pt import NarrowPass, PTOptions
    from fermat_tpu.scene.view import SceneView

    if scene == "bigroom":
        from fermat_tpu.core.camera import Camera
        from fermat_tpu.scene.procedural import big_room

        mesh = big_room(n_boxes=BIG_BOXES)
        cam = Camera.create(eye=(0.0, 3.0, 10.0), aim=(0.0, 1.5, 0.0))
        view = SceneView.build(mesh, cam)
    else:
        from fermat_tpu.scene.procedural import bathroom_standin

        mesh, cam, tdir = bathroom_standin(n_boxes=BIG_BOXES)
        view = SceneView.build(mesh, cam, texture_dir=tdir)
    opts = PTOptions(max_path_length=6, lobes=scene_lobes(mesh.materials))
    drv = NarrowPass(view, opts, *BIG_RES)
    for inst in (0, 1):
        jax.block_until_ready(drv(inst).composited.x)
    t0 = time.perf_counter()
    out = drv(2)
    jax.block_until_ready(out.composited.x)
    dt = time.perf_counter() - t0
    return {"mrays": float(out.rays) / dt / 1e6, "spp_s": 1.0 / dt}


def bench_integrators() -> dict:
    """A BPT pass and MLT chain-mutation throughput on the water-caustic
    stand-in (the SDS transport BPT exists for, renderers/bpt_impl.h).
    Compile and run times are reported apart."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.integrators import mlt as mlt_mod
    from fermat_tpu.integrators.bpt import BPTOptions, render_pass_fb
    from fermat_tpu.scene.procedural import caustic_standin
    from fermat_tpu.scene.view import SceneView

    mesh, cam = caustic_standin()
    view = SceneView.build(mesh, cam)
    inst = jnp.uint32(0)
    opts = BPTOptions(max_path_length=6, lobes=scene_lobes(mesh.materials))
    bpt = _compiled("bpt", jax.jit(
        lambda i: render_pass_fb(view, opts, RES, RES, i, 0)), inst)
    out = jax.block_until_ready(bpt(inst))
    best = _best(lambda rep: bpt(jnp.uint32(rep)).composited.x, reps=2)
    res = {"bpt_caustic512_spp_s": round(1.0 / best, 3),
           "bpt_caustic512_mrays": round(float(out.rays) / best / 1e6, 3)}

    mopts = mlt_mod.MLTOptions(lobes=scene_lobes(mesh.materials))
    mlt = _compiled("mlt", jax.jit(
        lambda i: mlt_mod.render_pass(view, mopts, RES, RES, i, 0)[0]), inst)
    jax.block_until_ready(mlt(inst))
    best = _best(lambda rep: mlt(jnp.uint32(rep)), reps=2)
    muts = RES * RES * mopts.steps_per_pass  # one chain per pixel
    res["mlt_caustic512_Mmut_s"] = round(muts / best / 1e6, 3)
    return res


def _compiled(name: str, fn, *args):
    """Compile `fn` for `args` and print how long that took."""
    t0 = time.perf_counter()
    c = fn.lower(*args).compile()
    print(f"bench: {name} compiled ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return c


def bench_train_textured() -> dict:
    """The AD train step on the textured bathroom stand-in at 800x448,
    gradient w.r.t. material diffuse albedo, with the forward time beside
    it."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.integrators.pt import PTOptions, render_pass
    from fermat_tpu.scene.procedural import bathroom_standin
    from fermat_tpu.scene.view import SceneView

    mesh, cam, tdir = bathroom_standin(n_boxes=BIG_BOXES)
    view = SceneView.build(mesh, cam, texture_dir=tdir)
    rx, ry = TEXTURED_RES
    opts = PTOptions(max_path_length=4, lobes=scene_lobes(mesh.materials))
    target = jnp.zeros((rx * ry, 3), jnp.float32)
    diffuse0 = view.mesh.materials.diffuse

    def loss_fn(diffuse, inst):
        mats = view.mesh.materials._replace(diffuse=diffuse)
        v = view._replace(mesh=view.mesh._replace(materials=mats))
        out = render_pass(v, opts, rx, ry, inst)
        img = out.composited.stack()
        return jnp.mean((img - target) ** 2), out.rays

    fwd_fn = jax.jit(loss_fn)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_l, rays), _g = jax.block_until_ready(grad_fn(diffuse0, jnp.uint32(0)))
    jax.block_until_ready(fwd_fn(diffuse0, jnp.uint32(0)))
    tf = _best(lambda rep: fwd_fn(diffuse0, jnp.uint32(rep)), reps=2)
    tg = _best(lambda rep: grad_fn(diffuse0, jnp.uint32(rep)), reps=2)
    return {
        "train_mrays_textured": round(float(rays) / tg / 1e6, 3),
        "train_textured_fwd_ms": round(tf * 1e3, 1),
        "train_textured_fwdbwd_ms": round(tg * 1e3, 1),
    }


def bench_bigscene(n_boxes: int = SWEEP_BOXES, res=BIG_RES) -> dict:
    """Closest-hit sweeps of 1.43M rays on big_room(n_boxes=50000), 600,036
    triangles, camera-coherent and incoherent, through the trace a pass
    takes with tracer="auto" (integrators.pt.make_tracer)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fermat_tpu.accel.bvh import build_bvh_for_mesh
    from fermat_tpu.core.camera import Camera, generate_camera_rays
    from fermat_tpu.core.math import Vec3, normalize
    from fermat_tpu.integrators.pt import PTOptions, make_tracer
    from fermat_tpu.scene.procedural import big_room

    room = big_room(n_boxes=n_boxes).device_view()
    bvh = build_bvh_for_mesh(room)
    closest = make_tracer(room, bvh, PTOptions())
    w, h = res
    n = w * h
    cam = Camera.create(eye=(0.0, 3.0, 10.0), aim=(0.0, 1.5, 0.0))
    tmin, tmax = jnp.float32(1e-4), jnp.float32(3e38)
    half = jnp.full((n,), 0.5, jnp.float32)
    oc, dc, _ = generate_camera_rays(cam, w, h, half, half)
    r = np.random.default_rng(3)
    o_np = (r.random((n, 3)).astype(np.float32) - 0.5) * 10.0
    o_np[:, 1] += 2.0
    d_np = r.standard_normal((n, 3)).astype(np.float32)
    oi = Vec3(*(jnp.asarray(o_np[:, i]) for i in range(3)))
    di = normalize(Vec3(*(jnp.asarray(d_np[:, i]) for i in range(3))))
    sweep = jax.jit(lambda o, d: closest(o, d, tmin, tmax, None).t)
    jax.block_until_ready(sweep(oc, dc))
    cc = _best(lambda _: sweep(oc, dc), reps=2)
    jax.block_until_ready(sweep(oi, di))
    ci = _best(lambda _: sweep(oi, di), reps=2)
    return {
        "bigscene600k_tris": int(room.n_triangles),
        "bigscene600k_camera_mrays": round(n / cc / 1e6, 2),
        "bigscene600k_incoh_mrays": round(n / ci / 1e6, 2),
    }


def _stage(name: str, fn, *args):
    """Run one stage and print its results and wall time on standard
    output as soon as it ends, so that a run cut by a time limit still
    shows how far it got."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"bench: {name} done ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(out)}", flush=True)
    return out


def card() -> str:
    """`name, power limit` from nvidia-smi (a child that stays off JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


STAGES = ("cornell512", "train", "bigroom", "bathroom", "bigscene")
OPTIONAL_STAGES = ("integrators",)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", default=",".join(STAGES),
                    help=f"comma-separated, from {STAGES + OPTIONAL_STAGES}")
    stages = ap.parse_args(argv).stages.split(",")
    unknown = set(stages) - set(STAGES + OPTIONAL_STAGES)
    if unknown:
        ap.error(f"unknown stages {sorted(unknown)}")

    import jax

    from fermat_tpu import platform

    platform.setup_compile_cache()
    dev = jax.devices()[0]
    line = {
        "metric": "Mrays/s (PT trace+shade, CornellBox 512x512)",
        "unit": "Mrays/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card() if dev.platform == "gpu" else None,
    }
    print(json.dumps(line), flush=True)

    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.integrators.pt import PTOptions
    from fermat_tpu.scene.procedural import cornell_box, cornell_camera
    from fermat_tpu.scene.view import SceneView

    scene = cornell_box(glossy_boxes=True)
    opts = PTOptions(max_path_length=6, lobes=scene_lobes(scene.materials))
    view = SceneView.build(scene, cornell_camera())
    if "cornell512" in stages:
        line["value"] = round(_stage("cornell512", bench_primary, view, opts),
                              2)
    if "train" in stages:
        line["train_mrays"] = round(_stage("train", bench_train, view, opts),
                                    2)
    if "bigroom" in stages:
        big = _stage("bigroom", bench_large_pass, "bigroom")
        line["bigroom_100k_1600x896_mrays"] = round(big["mrays"], 3)
    if "bathroom" in stages:
        try:
            bath = _stage("bathroom", bench_large_pass, "bathroom")
            line["bathroom2_standin_1600x896_spp_s"] = round(bath["spp_s"], 4)
            line["bathroom2_standin_mrays"] = round(bath["mrays"], 3)
            line.update(_stage("train_textured", bench_train_textured))
        except FileNotFoundError as e:
            # the stand-in reads the reference's bathroom2 materials and
            # textures; without them these two stages do not run (ROADMAP 2.1)
            line["bathroom2_standin"] = f"not run: {e}"
    if "integrators" in stages:
        line.update(_stage("integrators", bench_integrators))
    if "bigscene" in stages:
        line.update(_stage("bigscene", bench_bigscene))
    print(json.dumps(line))


if __name__ == "__main__":
    main()
