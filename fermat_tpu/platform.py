"""The one place that looks at the platform.

Two decisions live here:

  * routing: which tracer a pass calls (`tracer_for`). The hand-written GPU
    kernel (`ops/gpu_bvh_walk.py`) runs only where a program is compiled
    for a CUDA device; everywhere else the plain XLA path runs. Interpret
    mode (a Pallas kernel run on the CPU) is never inferred from the
    platform: a caller asks for it with `interpret=True`, which is what the
    CPU tests do.
  * the persistent compile cache: `JAX_COMPILATION_CACHE_DIR` when it is
    set, otherwise a fixed directory inside the checkout (`.jax_cache/`,
    listed in `.gitignore`). A fixed path is what lets a later process find
    the programs an earlier one compiled.
"""
from __future__ import annotations

import os

import jax

# Off the GPU, "auto" tests every triangle (`trace_*_brute`: one fused XLA
# loop over 128-triangle blocks) in scenes up to this many triangles and
# walks the tree above it.
BRUTE_MAX_TRIANGLES = 4096

TRACERS = ("auto", "bvh", "brute")

CACHE_DIR_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def on_gpu() -> bool:
    """True when JAX's default backend is a CUDA GPU."""
    return jax.default_backend() == "gpu"


def require_kernel_backend(kernel: str, interpret: bool) -> None:
    """Raise unless `kernel` (a GPU-only Pallas kernel) can run here: on a
    GPU, or on any backend when the caller asked for interpret mode."""
    if not interpret and not on_gpu():
        raise RuntimeError(
            f"{kernel} is a GPU kernel and the default backend is "
            f"{jax.default_backend()!r}; pass interpret=True to run it in "
            f"the Pallas interpreter")


def per_platform(args, gpu, other):
    """`gpu(*args)` where the computation is compiled for a CUDA device,
    `other(*args)` elsewhere. The choice is made when XLA lowers the
    program, so one jitted function serves data on the GPU and on the CPU
    of the same process (`lax.platform_dependent`)."""
    return jax.lax.platform_dependent(*args, cuda=gpu, default=other)


def tracer_for(tracer: str, n_triangles: int, *, brute, walk, kernel):
    """The trace function a pass calls, for PTOptions.tracer `tracer`.

    `brute` (every triangle) and `walk` (the XLA skip-link walk) are plain
    JAX tracers with one signature; `kernel` is a factory that returns the
    per-ray GPU walk with that signature. It is called only when JAX's
    default backend is a GPU, so a CPU-only host never traces the Triton
    kernel.

      * "brute": `brute` everywhere.
      * "bvh": on a GPU, the kernel where the program is compiled for the
        card (`per_platform`) and `walk` where it is compiled for the CPU;
        off the GPU, `walk`.
      * "auto": as "bvh", except that the plain tracer is `brute` for
        scenes up to BRUTE_MAX_TRIANGLES. On the GPU the kernel beats the
        all-triangles test even at 36 triangles (PERF.md, Findings), so the
        card has no threshold.
    """
    if tracer not in TRACERS:
        raise ValueError(f"tracer must be one of {TRACERS}, got {tracer!r}")
    if tracer == "brute":
        return brute
    small = tracer == "auto" and n_triangles <= BRUTE_MAX_TRIANGLES
    plain = brute if small else walk
    if not on_gpu():
        return plain
    gpu = kernel()
    return lambda *args: per_platform(args, gpu, plain)


def setup_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Honours `JAX_COMPILATION_CACHE_DIR` (JAX reads it itself, so nothing is
    set); otherwise caches in `CACHE_DIR_DEFAULT`."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR_DEFAULT
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
