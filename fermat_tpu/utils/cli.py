"""Command-line batch renderer.

Reference: src/main.cu:100-219 — progressive passes, TGA dump, RMSE vs a
reference image, -diff image-compare mode, -benchmark stats dump,
-save-intermediate power-of-2 checkpoints; global flags parsed as in
RenderingContextImpl::init (renderer.cu:493-579).

Usage:
  python -m fermat_tpu -pt -i models/CornellBox/CornellBox-JP.obj \
      -c models/CornellBox/camera-frontal.txt -r 256 256 -passes 16 -o out.tga

Renderer selection: -pt | -bpt (registry names; plugins add more).
Per-renderer options: -opt key=value (e.g. -opt max_path_length=8;
-opt narrow=1 enables the narrowing-wavefront pt driver — fastest for
large scenes where Russian roulette collapses the live wavefront).
Plugins: -plugin my_module  ->  import + my_module.register_plugin()
(the DLL register_plugin analog, hellopt_plugin.cpp:36-40).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Optional


def _parse_value(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "-cpu" in argv:
        # pin the CPU backend before any device is touched
        import jax

        jax.config.update("jax_platforms", "cpu")
    scene_path = None
    camera_path = None
    res = (512, 512)
    renderer = "pt"
    passes = 1
    out_path = "output.tga"
    ref_path = None
    diff_paths = None
    bench_path = None
    save_intermediate = False
    view_mode = False
    seed = 0
    opts = {}
    plugins = []

    from fermat_tpu.render.context import _RENDERER_REGISTRY

    # plugins load FIRST so their renderer flags validate during parsing
    # (renderer.cu:441-460 loads plugins during init for the same reason)
    for k, a in enumerate(argv):
        if a == "-plugin" and k + 1 < len(argv):
            import importlib

            mod = importlib.import_module(argv[k + 1])
            mod.register_plugin()
            print(f"loaded plugin {argv[k + 1]}", file=sys.stderr)

    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            i += 1; scene_path = argv[i]
        elif a == "-c":
            i += 1; camera_path = argv[i]
        elif a == "-r":
            res = (int(argv[i + 1]), int(argv[i + 2])); i += 2
        elif a == "-passes":
            i += 1; passes = int(argv[i])
        elif a == "-o":
            i += 1; out_path = argv[i]
        elif a == "-ref":
            i += 1; ref_path = argv[i]
        elif a == "-diff":
            diff_paths = (argv[i + 1], argv[i + 2]); i += 2
        elif a == "-benchmark":
            i += 1; bench_path = argv[i]
        elif a == "-save-intermediate":
            save_intermediate = True
        elif a == "-view":
            view_mode = True
        elif a == "-seed":
            i += 1; seed = int(argv[i])
        elif a == "-cpu":
            pass  # handled before imports at main() entry
        elif a == "-plugin":
            i += 1; plugins.append(argv[i])
        elif a == "-opt":
            i += 1
            k, v = argv[i].split("=", 1)
            opts[k] = _parse_value(v)
        elif a.startswith("-") and a[1:] in _RENDERER_REGISTRY:
            renderer = a[1:]
        else:
            print(f"unknown argument: {a}", file=sys.stderr)
            return 2
        i += 1

    from fermat_tpu.utils.image import read_image, write_tga
    from fermat_tpu.render.framebuffer import rmse as rmse_fn

    # -diff mode: RMSE between two images (main.cu:102-126)
    if diff_paths is not None:
        import jax.numpy as jnp

        a = read_image(diff_paths[0])
        b = read_image(diff_paths[1])
        r = float(rmse_fn(jnp.asarray(a), jnp.asarray(b)))
        print(f"RMSE: {r:.6f}")
        fc = abs(a - b).mean(-1)
        base = os.path.splitext(out_path)[0]
        write_tga(base + "_diff.tga", (fc / max(fc.max(), 1e-6))[..., None].repeat(3, -1))
        return 0

    if scene_path is None:
        print("missing -i <scene>", file=sys.stderr)
        return 2

    # scene load (renderer.cu:698-720 dispatch)
    from fermat_tpu.scene.loaders.fa import LoadedScene, load_fa, load_mesh_any
    from fermat_tpu.core.camera import load_camera_file

    ext = os.path.splitext(scene_path)[1].lower()
    dir_lights = ()
    point_lights = ()
    env_radiance = (0.0, 0.0, 0.0)
    env_map = None
    exposure, gamma = 1.0, 2.2
    if ext == ".fa":
        loaded = load_fa(scene_path, strict=False)
        mesh = loaded.mesh
        camera = loaded.camera
        dir_lights = tuple(loaded.dir_lights)
    elif ext == ".pbrt":
        from fermat_tpu.scene.loaders.pbrt import load_pbrt

        pb = load_pbrt(scene_path)
        mesh = pb.mesh
        camera = pb.camera
        env_radiance = pb.env_radiance
        env_map = pb.env_map
        dir_lights = tuple(pb.dir_lights)
        point_lights = tuple(pb.point_lights)
        exposure, gamma = pb.exposure, pb.gamma
        if res == (512, 512):
            res = pb.resolution
    else:
        mesh = load_mesh_any(scene_path)
        camera = None
    if camera_path:
        camera = load_camera_file(camera_path)
    if camera is None:
        from fermat_tpu.core.camera import Camera

        lo, hi = mesh.bbox()
        c = (lo + hi) / 2
        ext_len = float(max(hi - lo))
        camera = Camera.create(
            (c[0], c[1], c[2] + 1.5 * ext_len), tuple(c), (0, 1, 0), 1.0
        )
        print("warning: no camera given; using bbox default", file=sys.stderr)

    print(
        f"scene: {mesh.n_triangles} triangles, {len(mesh.materials)} materials",
        file=sys.stderr,
    )

    from fermat_tpu.render.context import RenderingContext

    ctx = RenderingContext.create(
        mesh, camera, res[0], res[1], renderer=renderer,
        dir_lights=dir_lights, point_lights=point_lights, seed=seed,
        texture_dir=os.path.dirname(os.path.abspath(scene_path)),
        env_radiance=env_radiance, env_map=env_map, **opts,
    )

    ref_img = read_image(ref_path) if ref_path else None
    # -view: interactive progressive viewer (glut_viewer.cu analog);
    # `passes` bounds the session when stdin is not a terminal
    if view_mode:
        from fermat_tpu.render.viewer import Viewer

        v = Viewer(ctx)
        frames = v.run(
            passes_per_frame=1,
            max_frames=None if sys.stdin.isatty() else max(passes, 1),
        )
        write_tga(out_path, ctx.image(exposure, gamma))
        print(f"viewer: {frames} frames, wrote {out_path}", file=sys.stderr)
        return 0

    t0 = time.time()
    next_dump = 1
    done = 0
    while done < passes:
        step = min(next_dump - done, passes - done) if save_intermediate else (
            passes - done
        )
        ctx.render(step)
        done += step
        if save_intermediate and done == next_dump:
            base = os.path.splitext(out_path)[0]
            write_tga(f"{base}_{done:05d}.tga", ctx.image(exposure, gamma))
            next_dump *= 2
        if ref_img is not None:
            import jax.numpy as jnp

            r = float(rmse_fn(ctx.fb.composited, jnp.asarray(ref_img)))
            print(f"pass {done}: RMSE {r:.6f}", file=sys.stderr)

    elapsed = time.time() - t0
    write_tga(out_path, ctx.image(exposure, gamma))
    print(f"wrote {out_path} ({passes} passes, {elapsed:.2f}s)", file=sys.stderr)

    if bench_path:
        stats = ctx.dump_speed_stats()
        stats["elapsed_s"] = elapsed
        stats["resolution"] = list(res)
        stats["renderer"] = renderer
        with open(bench_path, "w") as f:
            json.dump(stats, f, indent=2)
        print(f"wrote {bench_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
