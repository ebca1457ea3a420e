"""Attribute device time for the 512^2 bench pass to HLO fusions + sources.

Round-2 judge item #1: "Capture a profiler trace of the 512^2 bench, commit
the op breakdown ... until the ~2.2 ms/bounce mystery fusions are explained".

This joins everything from the chrome trace itself — each device event
carries `source`, `source_stack`, `bytes_accessed` and `model_flops` in
its args. Aggregates device ops by (op name, source line) and writes
PERF_ATTRIB.md.

Usage:  python tools/perf_attrib.py [--res 512] [--out PERF_ATTRIB.md]
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def aggregate(trace_dir: str):
    rows = collections.defaultdict(lambda: [0.0, 0, 0, 0, []])
    for fn in glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True):
        with gzip.open(fn, "rt") as fh:
            data = json.load(fh)
        for e in data.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = e.get("args", {}) or {}
            if "device_duration_ps" not in a:
                continue  # host-side events
            key = (e["name"], a.get("source", "?"))
            r = rows[key]
            r[0] += e["dur"] / 1e3
            r[1] += 1
            r[2] = int(a.get("bytes_accessed", 0))
            r[3] = int(a.get("model_flops", 0) or 0)
            r[4] = a.get("source_stack", "").split("\n")[:4]
    return sorted(rows.items(), key=lambda kv: -kv[1][0])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--out", default="PERF_ATTRIB.md")
    ap.add_argument("--bounces", type=int, default=6)
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()

    import jax

    from fermat_tpu import platform

    platform.setup_compile_cache()
    import jax.numpy as jnp

    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.integrators.pt import PTOptions, render_pass
    from fermat_tpu.scene.procedural import cornell_box, cornell_camera
    from fermat_tpu.scene.view import SceneView
    from fermat_tpu.utils.profiling import capture_trace

    if args.scene == "bathroom":
        from fermat_tpu.scene.procedural import bathroom_standin

        scene, cam, tdir = bathroom_standin(n_boxes=8300)
        view = SceneView.build(scene, cam, texture_dir=tdir)
        res_x, res_y = 1600, 896
    elif args.scene == "bigroom":
        from fermat_tpu.core.camera import Camera
        from fermat_tpu.scene.procedural import big_room

        scene = big_room(n_boxes=8300)
        cam = Camera.create(eye=(0.0, 3.0, 10.0), aim=(0.0, 1.5, 0.0))
        view = SceneView.build(scene, cam)
        res_x, res_y = 1600, 896
    else:
        scene = cornell_box(glossy_boxes=True)
        view = SceneView.build(scene, cornell_camera())
        res_x = res_y = args.res
    opts = PTOptions(max_path_length=args.bounces,
                     lobes=scene_lobes(scene.materials))

    # close over the view: passing it as a jit ARG makes it traced, which
    # disables the concrete-view fast paths (compact light tables, fused
    # shade) and silently profiles the fallback pipeline
    @jax.jit
    def one_pass(instance):
        out = render_pass(view, opts, res_x, res_y, instance)
        return out.composited.x.sum(), out.rays

    trace_dir = "/tmp/fermat_trace_attrib"
    shutil.rmtree(trace_dir, ignore_errors=True)
    t0 = time.time()
    r = capture_trace(lambda: one_pass(jnp.uint32(3)), trace_dir,
                      n_runs=args.runs)
    print(f"capture done in {time.time()-t0:.1f}s, rays/pass={float(r[1]):.0f}")

    rows = aggregate(trace_dir)
    total = sum(v[0] for _, v in rows)
    lines = [
        f"# PERF_ATTRIB — {args.scene} PT pass, per-op device attribution",
        "",
        f"Captured on `{jax.devices()[0].device_kind}` "
        f"({res_x}x{res_y}, {args.bounces} bounces, totals over {args.runs} runs; ops inside "
        "the bounce fori_loop run 5x per pass). Times joined with each "
        "fusion's `source` / `bytes_accessed` / `model_flops` trace args.",
        "",
        f"Total attributed device time: {total:.1f} ms "
        "(includes the outer jit + while wrappers, so leaf ops double-count "
        "against them).",
        "",
        "| total ms | n | MB/exec | MFLOP | op | source |",
        "|---|---|---|---|---|---|",
    ]
    for (name, src), (ms, cnt, by, fl, stack) in rows[:45]:
        lines.append(
            f"| {ms:.2f} | {cnt} | {by/1e6:.2f} | {fl/1e6:.1f} "
            f"| `{name[:40]}` | `{src}` |"
        )
    lines.append("")
    out_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), args.out
    )
    with open(out_path, "w") as fh:
        fh.write("\n".join(lines))
    print(f"wrote {out_path}")
    for (name, src), (ms, cnt, by, fl, stack) in rows[:18]:
        print(f"{ms:9.2f} ms x{cnt:4d}  {name[:32]:32s} {src}")


if __name__ == "__main__":
    main()
