"""Converged bathroom2-class artifact: golden render + RMSE curve.

VERDICT r3 #6: pin "bathroom2 spp/s converged" with a real measurement
instead of extrapolation. This tool renders the bathroom2 stand-in
(reference README.md:46-48 canonical demo; src/main.cu:171-204 progressive
accumulation loop), accumulating passes with power-of-2 checkpoints; the
final accumulation is the golden, and the RMSE of each checkpoint vs the
golden is the convergence curve. Results append to CONVERGENCE.md.

Usage:
  python tools/gen_convergence.py [--res 1600x896] [--spp 256]
      [--scene bathroom|bigroom|cornell] [--out CONVERGENCE.md]

Run alone on the GPU. Runtime ~ spp / (measured spp/s); the tool prints an ETA
after the first pass and each checkpoint line as it lands (flush=True), so
a killed run still leaves the partial curve in the log.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from fermat_tpu import platform

platform.setup_compile_cache()
import jax.numpy as jnp
import numpy as np


def build(scene: str, res_x: int, res_y: int):
    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.integrators.pt import PTOptions
    from fermat_tpu.scene.view import SceneView

    if scene == "bathroom":
        from fermat_tpu.scene.procedural import bathroom_standin

        mesh, cam, tdir = bathroom_standin(n_boxes=8300)
        view = SceneView.build(mesh, cam, texture_dir=tdir)
    elif scene == "bigroom":
        from fermat_tpu.core.camera import Camera
        from fermat_tpu.scene.procedural import big_room

        mesh = big_room(n_boxes=8300)
        cam = Camera.create(eye=(0.0, 3.0, 10.0), aim=(0.0, 1.5, 0.0))
        view = SceneView.build(mesh, cam)
    else:
        from fermat_tpu.scene.procedural import cornell_box, cornell_camera

        mesh = cornell_box(glossy_boxes=True)
        view = SceneView.build(mesh, cornell_camera())
    opts = PTOptions(max_path_length=6, lobes=scene_lobes(mesh.materials))
    return view, opts


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    # tone-mapped RMSE (x/(1+x)): unbounded HDR spikes otherwise dominate
    ta = a / (1.0 + a)
    tb = b / (1.0 + b)
    return float(np.sqrt(np.mean((ta - tb) ** 2)))


def rmse_linear(a: np.ndarray, b: np.ndarray) -> float:
    # linear-space RMSE: discriminates in the low-spp regime where the
    # tone-mapped metric saturates (VERDICT r4 #7: the 1->8 spp rows of
    # the tone-mapped curve were flat)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="1600x896")
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--scene", default="bathroom")
    ap.add_argument("--out", default=None)
    ap.add_argument("--narrow", action="store_true",
                    help="use the narrowing-wavefront driver (NarrowPass)")
    args = ap.parse_args()
    res_x, res_y = (int(v) for v in args.res.split("x"))

    print("connecting...", flush=True)
    print("backend:", jax.default_backend(), jax.devices(), flush=True)
    view, opts = build(args.scene, res_x, res_y)

    if args.narrow:
        from fermat_tpu.integrators.pt import NarrowPass

        drv = NarrowPass(view, opts, res_x, res_y)
        stack = jax.jit(lambda o: o.composited.stack())
        fn = lambda inst: stack(drv(inst))
    else:
        from fermat_tpu.integrators.pt import render_pass

        fn = jax.jit(lambda inst: render_pass(
            view, opts, res_x, res_y, inst).composited.stack())

    acc = np.zeros((res_x * res_y, 3), np.float64)
    checkpoints = {}
    t0 = time.time()
    nxt = 1
    for i in range(args.spp):
        img = np.asarray(jax.block_until_ready(fn(jnp.uint32(i))),
                         np.float64)
        acc += img
        spp = i + 1
        if spp == 1:
            dt = time.time() - t0
            print(f"pass 1: {dt:.1f}s -> ETA {(args.spp - 1) * dt / 60:.0f} "
                  f"min for {args.spp} spp", flush=True)
        if spp == nxt or spp == args.spp:
            checkpoints[spp] = (acc / spp).copy()
            print(f"checkpoint {spp} spp ({time.time()-t0:.0f}s)",
                  flush=True)
            nxt *= 2
            # crash/kill insurance: every checkpoint lands on disk, so a
            # budget-killed run salvages its deepest checkpoint as the
            # golden (tools/salvage_convergence.py rebuilds the table)
            np.savez_compressed(
                f"/tmp/conv_ckpt_{args.scene}_{args.res}.npz",
                **{str(s): v.astype(np.float32)
                   for s, v in checkpoints.items()},
                wall=np.float64(time.time() - t0))

    golden = checkpoints[args.spp]
    lines = [
        "",
        f"## {args.scene} {args.res}, {args.spp}-spp golden "
        f"({time.time()-t0:.0f}s wall, "
        f"{args.spp/(time.time()-t0):.4f} spp/s, "
        f"backend {jax.default_backend()})",
        "",
        "| spp | tone-mapped RMSE | ratio | linear RMSE | ratio |",
        "|---|---|---|---|---|",
    ]
    prev = prev_l = None
    for spp in sorted(checkpoints):
        if spp == args.spp:
            continue
        e = rmse(checkpoints[spp], golden)
        el = rmse_linear(checkpoints[spp], golden)
        ratio = "" if prev is None else f"{e/prev:.3f}"
        ratio_l = "" if prev_l is None else f"{el/prev_l:.3f}"
        lines.append(f"| {spp} | {e:.5f} | {ratio} | {el:.5f} | {ratio_l} |")
        print(lines[-1], flush=True)
        prev, prev_l = e, el
    out = args.out or os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "CONVERGENCE.md")
    header = not os.path.exists(out)
    with open(out, "a") as f:
        if header:
            f.write("# CONVERGENCE — progressive-accumulation RMSE curves\n"
                    "\nGenerated by tools/gen_convergence.py (golden = the "
                    "run's own final\naccumulation; RMSE tone-mapped "
                    "x/(1+x); MC expectation: RMSE halves\nper 4x spp, "
                    "ratio ~0.5 per power-of-2 row pair).\n")
        f.write("\n".join(lines) + "\n")
    # golden image artifact for later regression runs
    gdir = os.path.join(os.path.dirname(out), "tests", "golden")
    os.makedirs(gdir, exist_ok=True)
    np.savez_compressed(
        os.path.join(gdir, f"{args.scene}_{args.res}_{args.spp}spp.npz"),
        image=golden.astype(np.float32).reshape(res_y, res_x, 3))
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
