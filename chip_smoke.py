"""Run the renderer's main paths on the GPU and check each against its reference.

    python chip_smoke.py          # one card: phases device .. train
    python chip_smoke.py --four   # four cards: the sharded phase only

Phases run in order, each printing its checks and its wall time (compile
apart). Any failed check raises and the script exits non-zero; the last
line of standard output, one JSON object naming the device, is printed
only when every phase passed. Without a CUDA GPU the script exits non-zero
at once and prints no result.

References (plain float32, no kernel): the all-triangles tracer
(`trace_*_brute`) under `jax.default_matmul_precision("highest")`, and the
same jitted function run on the CPU backend in this process.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BIG_RES = (1600, 896)  # the big_room job: 1.43M lanes
BIG_BOXES = 8300  # big_room(n_boxes=8300): 99,636 triangles
CORNELL_RES = 512
PARITY_RES = 128  # GPU vs CPU comparisons
MAX_PATH = 6
TRAIN_STEPS = 3
TRAIN_LR = 4.0


def card() -> str:
    """`name, power limit` of the card from nvidia-smi (a child that stays
    off JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a CUDA GPU, JAX found "
                         f"{dev.platform!r}")
    return dev


class Phase:
    """Context manager printing a phase's wall time."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: ok "
                  f"({time.perf_counter() - self.t0:.1f} s wall)", flush=True)


def best_time(fn, *args, reps: int = 3) -> float:
    """Warm call, then the best of `reps` timed calls that end in
    block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def check(cond, what: str):
    if not cond:
        raise AssertionError(what)
    print(f"  check ok: {what}", flush=True)


# ---------------------------------------------------------------- scenes

def big_room_scene():
    from fermat_tpu.core.camera import Camera
    from fermat_tpu.scene.procedural import big_room

    # the camera of the big_room benchmark stage
    cam = Camera.create(eye=(0.0, 3.0, 10.0), aim=(0.0, 1.5, 0.0))
    return big_room(n_boxes=BIG_BOXES), cam


def camera_rays(cam, res):
    import jax.numpy as jnp

    from fermat_tpu.core.camera import generate_camera_rays

    n = res[0] * res[1]
    half = jnp.full((n,), 0.5, jnp.float32)
    o, d, _ = generate_camera_rays(cam, res[0], res[1], half, half)
    return o, d


def incoherent_rays(n, seed=3):
    """One bounce of incoherent rays: origins spread through the room,
    directions uniform."""
    import jax.numpy as jnp

    from fermat_tpu.core.math import Vec3, normalize

    r = np.random.default_rng(seed)
    o = (r.random((n, 3)).astype(np.float32) - 0.5) * 10.0
    o[:, 1] += 2.0
    d = r.standard_normal((n, 3)).astype(np.float32)
    return (Vec3(*(jnp.asarray(o[:, i]) for i in range(3))),
            normalize(Vec3(*(jnp.asarray(d[:, i]) for i in range(3)))))


# -------------------------------------------------------------- checks

def check_hits(mesh, o, d, hit, ref, what):
    """Hit/miss exact; t to rtol 1e-5; tri equal except at ties (another
    triangle's hit within a relative 1e-5 in t)."""
    import jax.numpy as jnp

    from fermat_tpu.accel.traverse import intersect_triangles

    m = np.asarray(ref.hit_mask)
    check(np.array_equal(np.asarray(hit.hit_mask), m),
          f"{what}: hit/miss equal on all {m.size} rays ({m.mean():.3f} hit)")
    t, t_ref = np.asarray(hit.t)[m], np.asarray(ref.t)[m]
    rel = np.abs(t - t_ref) / np.abs(t_ref)
    check(rel.max() <= 1e-5, f"{what}: t max rel diff {rel.max():.2e} <= 1e-5")
    tri, tri_ref = np.asarray(hit.tri), np.asarray(ref.tri)
    diff = m & (tri != tri_ref)
    n_tie = int(diff.sum())
    if n_tie:
        t_o, _, _, ok = intersect_triangles(
            mesh, jnp.asarray(np.maximum(tri, 0)), o, d, jnp.float32(1e-4),
            jnp.float32(np.inf))
        t_o, ok = np.asarray(t_o)[diff], np.asarray(ok)[diff]
        t_r = np.asarray(ref.t)[diff]
        tie = ok & (np.abs(t_o - t_r) <= 1e-5 * np.abs(t_r))
        check(tie.all(), f"{what}: all {n_tie} differing tri ids are ties")
    else:
        check(True, f"{what}: tri ids equal on every hit")


def image_close(img, ref, rtol, atol, share, what):
    """At least `share` of pixels have all channels within rtol/atol."""
    img, ref = np.asarray(img), np.asarray(ref)
    close = np.isclose(img, ref, rtol=rtol, atol=atol).all(axis=-1)
    check(close.mean() >= share,
          f"{what}: {close.mean():.5f} of pixels within rtol {rtol:g} / "
          f"atol {atol:g} (need >= {share:g})")


# -------------------------------------------------------------- phases

def phase_device(n_cards: int):
    import jax

    from fermat_tpu import platform

    with Phase("device"):
        devs = jax.devices()
        print(f"  card: {card()}")
        print(f"  jax {jax.__version__}; devices: {len(devs)} x "
              f"{devs[0].device_kind} ({devs[0].platform})")
        print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
        print(f"  compile cache: {platform.setup_compile_cache()}")
        check(len(devs) >= n_cards, f"{n_cards} card(s) visible")


def phase_kernels(label: str):
    import jax
    import jax.numpy as jnp

    from fermat_tpu.accel.bvh import build_bvh_for_mesh
    from fermat_tpu.accel.traverse import (
        trace_any,
        trace_closest,
        trace_closest_brute,
    )
    from fermat_tpu.ops.gather import one_hot_matmul_gather
    from fermat_tpu.ops.gpu_bvh_walk import (
        pack,
        trace_any_walk,
        trace_closest_walk,
    )
    from fermat_tpu.scene.procedural import (
        big_room,
        cornell_box,
        cornell_camera,
    )

    with Phase("kernels"):
        storage, cam = big_room_scene()
        mesh = storage.device_view()
        bvh = build_bvh_for_mesh(mesh)
        n = BIG_RES[0] * BIG_RES[1]
        print(f"  big_room: {mesh.n_triangles} triangles, {bvh.n_nodes} "
              f"nodes, {n} rays")
        tmin, tinf = jnp.float32(1e-4), jnp.float32(3e38)
        tables = pack(bvh, mesh)
        walk_c = jax.jit(lambda o, d: trace_closest_walk(tables, o, d,
                                                         tmin, tinf))
        walk_a = jax.jit(lambda o, d, t: trace_any_walk(tables, o, d,
                                                        tmin, t))
        xla_c = jax.jit(lambda o, d: trace_closest(bvh, mesh, o, d,
                                                   tmin, tinf))
        xla_a = jax.jit(lambda o, d, t: trace_any(bvh, mesh, o, d, tmin, t))
        brute_c = jax.jit(lambda o, d: trace_closest_brute(mesh, o, d,
                                                           tmin, tinf))
        # (rays, any-hit length that leaves some rays occluded and some not)
        rays = {"camera": (camera_rays(cam, BIG_RES), 10.0),
                "incoherent": (incoherent_rays(n), 2.0)}
        (o, d), reach = rays["camera"]
        for name, fn, args in (("walk closest", walk_c, (o, d)),
                               ("walk any", walk_a, (o, d, reach))):
            t0 = time.perf_counter()
            compiled = fn.lower(*args).compile()
            print(f"  {name}: compiled in {time.perf_counter() - t0:.1f} s; "
                  f"{compiled.memory_analysis()}")
        for kind, ((o, d), reach) in rays.items():
            t_any = jnp.float32(reach)
            with jax.default_matmul_precision("highest"):
                ref = jax.block_until_ready(brute_c(o, d))
            check_hits(mesh, o, d, walk_c(o, d), ref,
                       f"walk closest vs brute, {kind} rays")
            # any-hit agrees with the brute closest hit inside t_any
            occ_ref = np.asarray(ref.hit_mask & (ref.t < t_any))
            occ = np.asarray(walk_a(o, d, t_any))
            check(np.array_equal(occ, occ_ref),
                  f"walk any vs brute, {kind} rays: occluded equal on all "
                  f"rays ({occ.mean():.3f} occluded)")
            for q, kern, xla, args in (("closest", walk_c, xla_c, (o, d)),
                                       ("any", walk_a, xla_a, (o, d, t_any))):
                tk, tx = best_time(kern, *args), best_time(xla, *args)
                print(f"  time {kind} {q}: walk kernel {tk * 1e3:.3f} ms, "
                      f"XLA walk {tx * 1e3:.3f} ms ({tx / tk:.2f}x) [{label}]")

        # the brute/BVH threshold (platform.BRUTE_MAX_TRIANGLES)
        for scene_name, st, c, res in (
                ("cornell", cornell_box(), cornell_camera(), (512, 512)),
                ("big_room 4k", big_room(n_boxes=338), cam, (512, 512))):
            m2 = st.device_view()
            t2 = pack(build_bvh_for_mesh(m2), m2)
            o, d = camera_rays(c, res)
            tb = best_time(jax.jit(lambda o, d: trace_closest_brute(
                m2, o, d, tmin, tinf)), o, d)
            tk = best_time(jax.jit(lambda o, d: trace_closest_walk(
                t2, o, d, tmin, tinf)), o, d)
            print(f"  time {scene_name} ({m2.n_triangles} tris, "
                  f"{res[0]}x{res[1]} camera rays): brute {tb * 1e3:.3f} ms, "
                  f"walk kernel {tk * 1e3:.3f} ms [{label}]")

        # gather_rows: table[idx] vs the one-hot matmul
        r = np.random.default_rng(0)
        for rows, cols, lanes in ((36, 52, CORNELL_RES ** 2),
                                  (2048, 23, CORNELL_RES ** 2),
                                  (36, 52, n), (2048, 23, n)):
            table = jnp.asarray(r.random((rows, cols), np.float32))
            idx = jnp.asarray(r.integers(0, rows, lanes), jnp.int32)
            take = jax.jit(lambda t, i: t[i])
            onehot = jax.jit(one_hot_matmul_gather)
            check(np.array_equal(np.asarray(take(table, idx)),
                                 np.asarray(onehot(table, idx))),
                  f"gather {rows}x{cols} at {lanes} lanes: table[idx] == "
                  f"one-hot")
            tt, to = best_time(take, table, idx), best_time(onehot, table, idx)
            print(f"  time gather {rows}x{cols} at {lanes} lanes: table[idx] "
                  f"{tt * 1e3:.3f} ms, one-hot {to * 1e3:.3f} ms [{label}]")


def phase_render(label: str):
    import jax

    from fermat_tpu.render.context import RenderingContext

    with Phase("render"):
        storage, cam = big_room_scene()
        rx, ry = BIG_RES
        ctx = RenderingContext.create(storage, cam, rx, ry, renderer="pt",
                                      max_path_length=MAX_PATH)
        ctx.render(1)  # compiles
        img0 = np.asarray(ctx.fb.composited)
        check(np.isfinite(img0).all(), "big_room image finite")
        check(img0.mean() > 1e-3, f"big_room image not black "
              f"(mean {img0.mean():.4f})")
        ctx.render(3)
        dt = float(np.median(ctx.stats["pass_times"][1:]))
        rays = float(ctx.gbuffer["rays"])
        print(f"  big_room {rx}x{ry} pass (tracer=auto): {dt * 1e3:.1f} ms, "
              f"{rays / dt / 1e6:.2f} Mrays/s ({rays:.0f} rays) [{label}]")

        with jax.default_matmul_precision("highest"):
            ref = RenderingContext.create(storage, cam, rx, ry, renderer="pt",
                                          max_path_length=MAX_PATH,
                                          tracer="brute")
            ref.render(1)
        img_ref = np.asarray(ref.fb.composited)
        image_close(img0, img_ref, 1e-4, 1e-5, 0.999,
                    "big_room pass vs tracer='brute'")
        mrd = np.abs(img0 - img_ref).sum() / np.abs(img_ref).sum()
        check(mrd < 1e-4, f"big_room mean relative difference vs brute "
              f"{mrd:.2e} < 1e-4")
        del ref

        nar = RenderingContext.create(storage, cam, rx, ry, renderer="pt",
                                      max_path_length=MAX_PATH, narrow=True)
        nar.render(1)
        img_n = np.asarray(nar.fb.composited)
        check(np.allclose(img_n, img0, rtol=1e-5, atol=1e-6),
              "narrowing driver == monolithic pass (rtol 1e-5, atol 1e-6)")
        nar.render(3)
        dtn = float(np.median(nar.stats["pass_times"][1:]))
        print(f"  big_room {rx}x{ry} pass, narrowing driver: "
              f"{dtn * 1e3:.1f} ms [{label}]")


def _cornell():
    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.integrators.pt import PTOptions
    from fermat_tpu.scene.procedural import cornell_box, cornell_camera
    from fermat_tpu.scene.view import SceneView

    scene = cornell_box(glossy_boxes=True)
    view = SceneView.build(scene, cornell_camera())
    opts = PTOptions(max_path_length=MAX_PATH,
                     lobes=scene_lobes(scene.materials))
    return scene, view, opts


def _loss_fn(opts, res, n_passes):
    """MSE of the mean of `n_passes` passes against a target, as a
    function of the material diffuse albedo (the inverse-rendering step
    of bench.py)."""
    import jax.numpy as jnp

    from fermat_tpu.integrators.pt import render_pass

    def loss(diffuse, view, target, instance0):
        mats = view.mesh.materials._replace(diffuse=diffuse)
        v = view._replace(mesh=view.mesh._replace(materials=mats))
        img = sum(render_pass(v, opts, res, res, instance0 + i)
                  .composited.stack() for i in range(n_passes)) / n_passes
        return jnp.mean((img - target) ** 2), img

    return loss


def phase_cornell(label: str):
    import jax
    import jax.numpy as jnp

    from fermat_tpu.render.context import RenderingContext
    from fermat_tpu.scene.procedural import cornell_box, cornell_camera

    with Phase("cornell"):
        ctx = RenderingContext.create(cornell_box(glossy_boxes=True),
                                      cornell_camera(), CORNELL_RES,
                                      CORNELL_RES, renderer="pt",
                                      max_path_length=MAX_PATH)
        ctx.render_batch(16)  # compiles
        img = np.asarray(ctx.fb.composited)
        check(np.isfinite(img).all() and img.mean() > 1e-2,
              f"cornell512 render_batch(16) finite, not black "
              f"(mean {img.mean():.4f})")
        ctx.render_batch(16)
        n_p, dt = ctx.stats["batch_times"][-1]
        print(f"  cornell512 render_batch(16): {dt / n_p * 1e3:.2f} ms/pass "
              f"[{label}]")

        # GPU vs CPU: the same jitted 2-pass image + albedo gradient
        _, view, opts = _cornell()
        f = jax.jit(jax.value_and_grad(_loss_fn(opts, PARITY_RES, 2),
                                       has_aux=True))
        cpu = jax.devices("cpu")[0]
        target = jnp.full((PARITY_RES * PARITY_RES, 3), 0.5, jnp.float32)
        args = (view.mesh.materials.diffuse, view, target, jnp.uint32(0))
        (_, img_g), g_g = f(*args)
        (_, img_c), g_c = f(*jax.device_put(args, cpu))
        image_close(img_g, img_c, 1e-3, 1e-5, 0.99,
                    f"cornell {PARITY_RES}^2 2-pass image, GPU vs CPU")
        g_g, g_c = np.asarray(g_g.stack()), np.asarray(g_c.stack())
        scale = np.abs(g_c).max()
        check(np.isfinite(g_g).all() and np.allclose(
            g_g, g_c, rtol=1e-3, atol=1e-3 * scale),
              f"albedo gradient GPU vs CPU within rtol 1e-3 (max |g| "
              f"{scale:.3e}, max diff {np.abs(g_g - g_c).max():.3e})")


def phase_train(label: str):
    import jax
    import jax.numpy as jnp

    with Phase("train"):
        _, view, opts = _cornell()
        loss = _loss_fn(opts, CORNELL_RES, 1)
        truth = view.mesh.materials.diffuse
        target = jax.jit(lambda v: loss(truth, v, 0.0, jnp.uint32(0))[1])(view)
        step = jax.jit(jax.value_and_grad(loss, has_aux=True))
        diffuse = jax.tree_util.tree_map(lambda a: jnp.full_like(a, 0.5),
                                         truth)
        losses = []
        for k in range(TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            (lv, _), g = jax.block_until_ready(
                step(diffuse, view, target, jnp.uint32(0)))
            dt = time.perf_counter() - t0
            g_np = np.asarray(g.stack())
            check(np.isfinite(g_np).all(), f"step {k}: gradient finite")
            losses.append(float(lv))
            print(f"  step {k}: loss {float(lv):.6e}, fwd+bwd {dt * 1e3:.1f} ms"
                  f"{' (compile)' if k == 0 else ''} [{label}]")
            diffuse = jax.tree_util.tree_map(
                lambda p, gp: jnp.clip(p - TRAIN_LR * gp, 0.0, 1.0),
                diffuse, g)
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"loss falls every step: {losses}")


def phase_four(label: str):
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators.pt import PTOptions, render_pass
    from fermat_tpu.parallel.mesh import (
        make_mesh,
        render_pass_gspmd,
        render_pass_sharded,
        train_step_sharded,
    )
    from fermat_tpu.scene.view import SceneView

    with Phase("four"):
        mesh = make_mesh(jax.devices()[:4])
        storage, cam = big_room_scene()
        view = SceneView.build(storage, cam)
        from fermat_tpu.bsdf.composite import scene_lobes

        opts = PTOptions(max_path_length=MAX_PATH,
                         lobes=scene_lobes(storage.materials))
        rx, ry = BIG_RES
        single = jax.jit(lambda v, i: render_pass(v, opts, rx, ry, i))
        out_1 = single(view, jnp.uint32(0))
        sharded = jax.jit(lambda v, i: render_pass_sharded(v, opts, rx, ry, i,
                                                           mesh))
        out_s = sharded(view, jnp.uint32(0))
        shard_devs = {s.device for s in out_s.composited.x.addressable_shards}
        check(len(shard_devs) == 4, f"sharded pass output spans 4 cards: "
              f"{sorted(str(d) for d in shard_devs)}")
        check(np.allclose(np.asarray(out_s.composited.stack()),
                          np.asarray(out_1.composited.stack()),
                          rtol=1e-5, atol=1e-6),
              f"render_pass_sharded big_room {rx}x{ry} == single card "
              f"(rtol 1e-5, atol 1e-6)")
        check(float(out_s.rays) == float(out_1.rays),
              f"ray count equal: {float(out_s.rays):.0f}")
        counts = np.asarray(out_s.rays_lane).reshape(4, -1).sum(axis=1)
        print(f"  per-card rays: {counts.astype(np.int64).tolist()} "
              f"(min/max {counts.min() / counts.max():.3f})")
        t1 = best_time(single, view, jnp.uint32(1), reps=2)
        ts = best_time(sharded, view, jnp.uint32(1), reps=2)
        print(f"  big_room pass: 1 card {t1 * 1e3:.1f} ms, 4 cards "
              f"{ts * 1e3:.1f} ms ({t1 / ts:.2f}x) [{label}]")
        out_g = render_pass_gspmd(view, opts, rx, ry, jnp.uint32(0), mesh)
        check(np.allclose(np.asarray(out_g.composited.stack()),
                          np.asarray(out_1.composited.stack()),
                          rtol=1e-5, atol=1e-6),
              "render_pass_gspmd == single card (rtol 1e-5, atol 1e-6)")
        for d in jax.devices()[:4]:
            st = d.memory_stats() or {}
            print(f"  {d}: peak {st.get('peak_bytes_in_use', 0) / 2**30:.2f}"
                  f" GiB")

        # gradient of the train step, sharded vs single card
        _, cview, copts = _cornell()
        res = CORNELL_RES
        target = jnp.full((res * res, 3), 0.5, jnp.float32)

        def loss_with(render):
            def f(diffuse):
                mats = cview.mesh.materials._replace(diffuse=diffuse)
                v = cview._replace(mesh=cview.mesh._replace(materials=mats))
                img = render(v).composited.stack()
                return jnp.mean((img - target) ** 2)
            return jax.jit(jax.value_and_grad(f))

        l1, g1 = loss_with(lambda v: render_pass(
            v, copts, res, res, jnp.uint32(0)))(cview.mesh.materials.diffuse)
        ls, gs = loss_with(lambda v: render_pass_sharded(
            v, copts, res, res, jnp.uint32(0), mesh))(
                cview.mesh.materials.diffuse)
        # the pixel mean is summed in another order (four partial sums and
        # a psum), so components near zero differ by the f32 rounding of
        # the whole sum: atol is relative to the gradient's scale
        g1, gs = np.asarray(g1.stack()), np.asarray(gs.stack())
        scale = np.abs(g1).max()
        check(np.allclose(gs, g1, rtol=1e-4, atol=1e-4 * scale),
              f"sharded albedo gradient == single card (rtol 1e-4, atol "
              f"1e-4 x max|g| = {1e-4 * scale:.2e}; max diff "
              f"{np.abs(gs - g1).max():.2e})")
        _, loss_step = jax.jit(lambda v, t: train_step_sharded(
            v, t, copts, res, res, jnp.uint32(0), mesh))(cview, target)
        check(np.isclose(float(loss_step), float(l1), rtol=1e-4),
              f"train_step_sharded loss {float(loss_step):.6e} == single "
              f"card {float(l1):.6e} (rtol 1e-4, sum order)")


def main(argv) -> int:
    four = "--four" in argv
    dev = require_gpu()
    import jax

    label = card()
    phase_device(4 if four else 1)
    if four:
        phase_four(label)
    else:
        phase_kernels(label)
        phase_render(label)
        phase_cornell(label)
        phase_train(label)
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
