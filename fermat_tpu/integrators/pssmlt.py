"""Primary-sample-space Metropolis light transport (Kelemen PSSMLT).

Reference: src/renderers/pssmlt.{h,cu} —
  * seed pass: sample candidate paths, record luminances into a CDF,
    resample chain seeds luminance-proportionally (pssmlt.cu:326-345)
  * image brightness b = E[I] as the MH normalization constant
  * per step: perturb the primary vector (independent large steps mixed
    with small exponential steps, `PerturbedPrimaryCoords`
    bpt_samplers.h:90-121), re-trace, Metropolis accept/reject with both
    states splatted at their expected-value weights (pssmlt.cu:153-322,
    `accept_reject_accumulate` with atomic splats).

Shape: chains are lanes. The path evaluator is the SAME jitted
integrator machinery driven by a MatrixSequence of per-chain primary
samples. `path_space="bpt"` (the default, matching the reference — chains
re-trace through BPTLib, pssmlt.cu:326-345) evaluates full bidirectional
path sets: a chain's contribution is its eye-strategy radiance PLUS all of
its light-tracing splats, carried as a (K,)-slot pixel/contrib set through
accept/reject (the reference's per-chain connections sink).
`path_space="pt"` keeps the cheaper unidirectional evaluator. Splats are
scatter-adds (atomic-splat analog).

State lives in a PssmltState pytree threaded through passes.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from fermat_tpu.core.math import Vec3
from fermat_tpu.core.rng import hash_combine, pcg_2d, uniform_from_bits
from fermat_tpu.integrators import pt as pt_mod
from fermat_tpu.scene.view import SceneView

Array = jax.Array
_U32 = jnp.uint32


class MatrixSequence(NamedTuple):
    """Sampler over an explicit (N, D) primary-sample matrix.

    Dim d of lane i reads u[i, d] — the chain-controlled analog of
    PerturbedPrimaryCoords (bpt_samplers.h:90-121).
    """

    u: Array  # (N, D)

    def _col(self, dim):
        d = jnp.clip(jnp.asarray(dim, jnp.int32), 0, self.u.shape[1] - 1)
        return jax.lax.dynamic_index_in_dim(self.u.T, d, axis=0, keepdims=False)

    def sample_1d(self, pix, dim):
        return self._col(dim)

    def sample_2d(self, pix, dim):
        return self._col(dim), self._col(jnp.asarray(dim, jnp.int32) + 1)

    def sample_3d(self, pix, dim):
        d = jnp.asarray(dim, jnp.int32)
        return self._col(d), self._col(d + 1), self._col(d + 2)


class PssmltOptions(NamedTuple):
    """pssmlt.h options subset (spp == chains-per-pixel is implicit: one
    chain per pixel lane)."""

    max_path_length: int = 6
    large_step_prob: float = 0.3  # independent-mutation mixture weight
    small_step_size: float = 1.0 / 64.0  # exp-step scale (Kelemen s2)
    n_seed_candidates: int = 4  # seeding oversampling factor
    tracer: str = "auto"
    path_space: str = "bpt"  # "bpt" (reference parity) | "pt" (cheaper)


class PssmltState(NamedTuple):
    u: Array  # (N, D) current primary vectors
    i_lum: Array  # (N,) current path-set total luminance
    contrib: Array  # (N, K, 3) current contribution set
    pixel: Array  # (N, K) pixel ids (-1 = empty slot)
    brightness: Array  # scalar normalization b
    key: Array  # u32 counter for mutation randomness


def _luminance(c: Array) -> Array:
    """(…, 3) -> (…,) luminance."""
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


# BPT's fixed QMC dim layout tops out at 300 + (L-2)*dpb + 3 (eye
# continuation dims, bpt.py); PSSMLT must mutate the whole range.
_BPT_DIM_BASE = 304


def _dims(opts: PssmltOptions) -> int:
    dpb = pt_mod.PTOptions().dims_per_bounce
    if opts.path_space == "bpt":
        return _BPT_DIM_BASE + opts.max_path_length * dpb
    return 2 + opts.max_path_length * dpb


def _n_slots(opts: PssmltOptions) -> int:
    """Contribution slots per chain: 1 eye set + (L-1) light-tracing splats."""
    return opts.max_path_length if opts.path_space == "bpt" else 1


def _eval_paths(
    view: SceneView, opts: PssmltOptions, res_x: int, res_y: int, u: Array
) -> Tuple[Array, Array]:
    """Trace the path set described by primary vectors u.

    Returns (contrib (N, K, 3), pixel (N, K) int32, -1 = empty slot).
    """
    n = u.shape[0]
    # dims 0,1 choose the image point: pixel + intra-pixel jitter
    px = jnp.clip((u[:, 0] * res_x).astype(jnp.int32), 0, res_x - 1)
    py = jnp.clip((u[:, 1] * res_y).astype(jnp.int32), 0, res_y - 1)
    pixel = (py * res_x + px).astype(jnp.uint32)
    jx = u[:, 0] * res_x - px
    jy = u[:, 1] * res_y - py
    u_mod = u.at[:, 0].set(jx).at[:, 1].set(jy)
    if opts.path_space == "bpt":
        from fermat_tpu.integrators import bpt as bpt_mod

        bpt_opts = bpt_mod.BPTOptions(
            max_path_length=opts.max_path_length, tracer=opts.tracer
        )
        rad, _img, _rays, sp, sr = bpt_mod.render_pass(
            view, bpt_opts, res_x, res_y, jnp.uint32(0),
            pix=pixel, sequence=MatrixSequence(u_mod),
            return_splat_list=True,
        )
        eye = jnp.stack([rad.x, rad.y, rad.z], axis=-1)  # (N, 3)
        contrib = jnp.concatenate([eye[:, None, :], sr], axis=1)
        pixels = jnp.concatenate(
            [pixel.astype(jnp.int32)[:, None], sp], axis=1
        )
        return contrib, pixels
    pt_opts = pt_mod.PTOptions(
        max_path_length=opts.max_path_length, rr=False, tracer=opts.tracer
    )
    out = pt_mod.render_pass(
        view, pt_opts, res_x, res_y, jnp.uint32(0),
        pix=pixel, sequence=MatrixSequence(u_mod),
    )
    contrib = jnp.stack(
        [out.composited.x, out.composited.y, out.composited.z], axis=-1
    )
    return contrib[:, None, :], pixel.astype(jnp.int32)[:, None]


def init_state(
    view: SceneView, opts: PssmltOptions, res_x: int, res_y: int, n: int, seed: int = 0
) -> PssmltState:
    """Seed pass (pssmlt.cu:326-345): luminance-proportional chain seeds +
    image brightness estimate."""
    d = _dims(opts)
    k = _n_slots(opts)
    key0 = _U32((seed * 2654435761 + 12345) & 0xFFFFFFFF)
    best_u = None
    best_lum = jnp.full(n, -1.0)
    best_contrib = jnp.zeros((n, k, 3))
    best_pixel = jnp.full((n, k), -1, jnp.int32)
    total = jnp.zeros(())
    # luminance-weighted reservoir resampling over candidate rounds — the
    # streaming equivalent of the reference's CDF inversion
    for c in range(opts.n_seed_candidates):
        ctr = jax.lax.broadcasted_iota(_U32, (n, d), 0) * _U32(d) + jax.lax.broadcasted_iota(_U32, (n, d), 1)
        bits = hash_combine(hash_combine(key0, _U32(c + 1)), ctr)
        u = uniform_from_bits(bits)
        contrib, pixel = _eval_paths(view, opts, res_x, res_y, u)
        lum = jnp.sum(_luminance(contrib), axis=1)  # total over the path set
        total = total + jnp.mean(lum)
        # weighted reservoir: keep candidate with prob lum/(acc+lum)
        acc = jnp.maximum(best_lum, 0.0) + lum
        r = uniform_from_bits(hash_combine(key0 ^ _U32(0xABCD), hash_combine(_U32(c), jnp.arange(n, dtype=_U32))))
        take = (best_lum < 0.0) | (r * acc < lum)
        best_u = u if best_u is None else jnp.where(take[:, None], u, best_u)
        best_lum = jnp.where(take, lum, jnp.maximum(best_lum, 0.0))
        best_contrib = jnp.where(take[:, None, None], contrib, best_contrib)
        best_pixel = jnp.where(take[:, None], pixel, best_pixel)
    brightness = total / opts.n_seed_candidates
    return PssmltState(
        u=best_u,
        i_lum=best_lum,
        contrib=best_contrib,
        pixel=best_pixel,
        brightness=brightness,
        key=key0 ^ _U32(0x5BD1E995),
    )


def _mutate(u: Array, key: Array, opts: PssmltOptions) -> Array:
    """Kelemen mutation: large step w.p. p, else symmetric exp small step."""
    n, d = u.shape
    ctr = jax.lax.broadcasted_iota(_U32, (n, d), 0) * _U32(d) + jax.lax.broadcasted_iota(_U32, (n, d), 1)
    b1 = hash_combine(key, ctr)
    b2 = hash_combine(key ^ _U32(0x9E3779B9), ctr)
    r1 = uniform_from_bits(b1)
    r2 = uniform_from_bits(b2)
    large = uniform_from_bits(hash_combine(key ^ _U32(0x85EBCA6B), jnp.arange(n, dtype=_U32)))
    is_large = (large < opts.large_step_prob)[:, None]
    # small step: Kelemen exponential perturbation (pssmlt primary mutation).
    # The 1/64 constant is tuned for PT's ~50 primary dims; every dim moves
    # each step, so the expected path-space displacement grows ~ sqrt(D) —
    # rescale so BPT's ~350-dim vectors keep the same ||delta u|| (measured:
    # without this, acceptance drops and 32^2 chains mix ~2x slower).
    s1 = 1.0 / 1024.0
    s2 = opts.small_step_size * min(1.0, (50.0 / d) ** 0.5)
    mag = s2 * jnp.exp(-jnp.log(s2 / s1) * r1)
    delta = jnp.where(r2 < 0.5, mag, -mag)
    u_small = jnp.mod(u + delta, 1.0)
    return jnp.where(is_large, r1, u_small)


def step(
    view: SceneView,
    opts: PssmltOptions,
    res_x: int,
    res_y: int,
    state: PssmltState,
) -> Tuple[PssmltState, Array]:
    """One Metropolis step for all chains; returns (state, splat image (H*W,3)).

    Expected-value splatting (pssmlt.cu:153-322): old state weighted by
    (1-a), proposal by a, both scaled so the accumulated image is unbiased
    with mean brightness b.
    """
    n = state.u.shape[0]
    key = hash_combine(state.key, _U32(0x1234567))
    u_prop = _mutate(state.u, key, opts)
    contrib_p, pixel_p = _eval_paths(view, opts, res_x, res_y, u_prop)
    lum_p = jnp.sum(_luminance(contrib_p), axis=1)
    lum_c = jnp.maximum(state.i_lum, 0.0)
    a = jnp.clip(lum_p / jnp.maximum(lum_c, 1e-12), 0.0, 1.0)
    a = jnp.where(lum_c <= 0.0, 1.0, a)

    b = state.brightness
    # normalization: each chain splats total weight b per step
    w_old = (1.0 - a) * b / jnp.maximum(lum_c, 1e-12)
    w_new = a * b / jnp.maximum(lum_p, 1e-12)
    w_old = jnp.where(lum_c > 0.0, w_old, 0.0)
    w_new = jnp.where(lum_p > 0.0, w_new, 0.0)

    splat = jnp.zeros((res_x * res_y, 3), jnp.float32)
    # every slot of the path set splats with its chain's weight; -1 slots
    # are dropped by the out-of-bounds scatter mode (their rgb is 0 anyway)
    splat = splat.at[state.pixel.reshape(-1)].add(
        (state.contrib * w_old[:, None, None]).reshape(-1, 3), mode="drop")
    splat = splat.at[pixel_p.reshape(-1)].add(
        (contrib_p * w_new[:, None, None]).reshape(-1, 3), mode="drop")
    # per-pass image scale: chains-per-pixel normalization
    splat = splat * (res_x * res_y / jnp.float32(n))

    u_rng = uniform_from_bits(hash_combine(key ^ _U32(0xC2B2AE35), jnp.arange(n, dtype=_U32)))
    accept = u_rng < a
    new_state = PssmltState(
        u=jnp.where(accept[:, None], u_prop, state.u),
        i_lum=jnp.where(accept, lum_p, state.i_lum),
        contrib=jnp.where(accept[:, None, None], contrib_p, state.contrib),
        pixel=jnp.where(accept[:, None], pixel_p, state.pixel),
        brightness=state.brightness,
        key=hash_combine(key, _U32(0xDEADBEEF)),
    )
    return new_state, splat
