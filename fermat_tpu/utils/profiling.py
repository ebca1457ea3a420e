"""Profiling utilities.

Reference analog (SURVEY.md §5): host-side cugar::Timer wrapping each stage
into PTLoopStats (pathtracer_kernels.h:282-305), and the DEVICE_TIMING
clock64() per-shade-event breakdown (pathtracer_core.h:480-565,
print_timer_stats pathtracer_kernels.h:393-454).

Equivalents here:
  * per-pass wall timers (RenderingContext.stats / dump_speed_stats)
  * `capture_trace` — jax.profiler capture around a callable
  * `op_breakdown` — aggregate per-op device time from the captured chrome
    trace (the DEVICE_TIMING print analog; works without tensorboard)
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import Callable, Dict, List, Tuple

import jax


def capture_trace(fn: Callable, out_dir: str, n_runs: int = 3):
    """Run fn() n_runs times under the JAX profiler; returns last result."""
    r = jax.block_until_ready(fn())  # compile outside the capture
    jax.profiler.start_trace(out_dir)
    for _ in range(n_runs):
        r = fn()
    jax.block_until_ready(r)
    jax.profiler.stop_trace()
    return r


def op_breakdown(trace_dir: str, top: int = 30) -> List[Tuple[str, float, int]]:
    """Aggregate (op name, total ms, count) from chrome traces under trace_dir."""
    agg: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    for fn in glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True):
        with gzip.open(fn, "rt") as fh:
            data = json.load(fh)
        for ev in data.get("traceEvents", []):
            if ev.get("ph") == "X" and "dur" in ev:
                name = ev.get("name", "?")
                agg[name] += ev["dur"] / 1e3
                cnt[name] += 1
    out = [(name, ms, cnt[name]) for name, ms in agg.items()]
    out.sort(key=lambda x: -x[1])
    return out[:top]


def print_op_breakdown(trace_dir: str, top: int = 30) -> None:
    """print_timer_stats analog."""
    for name, ms, n in op_breakdown(trace_dir, top):
        print(f"{ms:10.3f} ms  x{n:6d}  {name[:100]}")
