"""Edge-avoiding A-trous wavelet (EAW) denoiser + variance prefilter.

Reference: src/eaw.{h,cu} (B3-spline 5x5 taps with kernelWeights
{1, 2/3, 1/6} — eaw.cu:55; color/normal/position edge-stopping weights —
eaw.cu:74-121; norm_diff = 1 - dot — eaw.cu:35-41) and the filtering driver
renderer.cu:1099-1217 (7 iterations with doubling steps, per-channel
demodulation by albedo, variance-adaptive phi_color, box-prefiltered
variance renderer.cu:366-399).

Shape: each tap is a jnp.roll + mask over the whole (H, W, 3) plane —
25 taps x 7 iterations of elementwise work, no gathers.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fermat_tpu.core.camera import Camera, camera_frame
from fermat_tpu.core.math import Vec3, dot

Array = jax.Array

_KW = (1.0, 2.0 / 3.0, 1.0 / 6.0)  # B3 spline (eaw.cu:55)


class EAWParams(NamedTuple):
    """eaw.h EAWParams; defaults follow renderer.cu:1114-1118."""

    phi_normal: float = 2.0
    phi_position: float = 1.0
    phi_color: float = 1.0e-4  # (instance^2+1)/10000 at instance 0
    n_iterations: int = 7


def filter_variance(var: Array, fw: int = 2) -> Array:
    """(2fw+1)^2 box prefilter of the variance plane (renderer.cu:366-399)."""
    h, w = var.shape
    acc = jnp.zeros_like(var)
    cnt = jnp.zeros_like(var)
    ones = jnp.ones_like(var)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    for dy in range(-fw, fw + 1):
        for dx in range(-fw, fw + 1):
            shifted = jnp.roll(var, (-dy, -dx), (0, 1))
            valid = ((yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0) & (xx + dx < w))
            acc = acc + jnp.where(valid, shifted, 0.0)
            cnt = cnt + valid.astype(var.dtype)
    return acc / jnp.maximum(cnt, 1.0)


def _pos_radius(position: Array, cam: Camera, res_x: int, res_y: int) -> Array:
    """Per-pixel world-space pixel footprint (eaw.cu:62-64)."""
    u, v, w = camera_frame(cam, res_x / res_y)
    ulen = jnp.sqrt(dot(u, u))
    vlen = jnp.sqrt(dot(v, v))
    wlen2 = dot(w, w)
    rel = position - jnp.stack([cam.eye.x, cam.eye.y, cam.eye.z])
    depth_w = (
        rel[..., 0] * w.x + rel[..., 1] * w.y + rel[..., 2] * w.z
    ) / wlen2
    return 20.0 * jnp.minimum(ulen / res_x, vlen / res_y) * depth_w


def eaw_step(
    img: Array,  # (H, W, 3)
    normal: Array,  # (H, W, 3)
    position: Array,  # (H, W, 3)
    miss: Array,  # (H, W) bool
    var: Array,  # (H, W) prefiltered variance
    pos_radius: Array,  # (H, W)
    params: EAWParams,
    step: int,
) -> Array:
    h, w = img.shape[:2]
    phi_n = params.phi_normal * step * step
    phi_p = params.phi_position / jnp.maximum(pos_radius * pos_radius, 1e-12)
    phi_c = params.phi_color / jnp.maximum(1e-3, var * var)

    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    sum_w = jnp.zeros((h, w), img.dtype)
    sum_c = jnp.zeros_like(img)
    for ty in (-2, -1, 0, 1, 2):
        for tx in (-2, -1, 0, 1, 2):
            dy, dx = ty * step, tx * step
            kern = _KW[abs(ty)] * _KW[abs(tx)]
            c_p = jnp.roll(img, (-dy, -dx), (0, 1))
            n_p = jnp.roll(normal, (-dy, -dx), (0, 1))
            p_p = jnp.roll(position, (-dy, -dx), (0, 1))
            m_p = jnp.roll(miss, (-dy, -dx), (0, 1))
            inside = (
                (yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0) & (xx + dx < w)
            ) & ~m_p
            dc = c_p - img
            w_color = jnp.sum(dc * dc, -1) * phi_c
            w_normal = (1.0 - jnp.maximum(jnp.sum(n_p * normal, -1), 1e-8)) * phi_n
            dp = p_p - position
            w_pos = jnp.sum(dp * dp, -1) * phi_p
            wgt = kern * jnp.exp(
                -jnp.maximum(w_pos, 0.0)
                - jnp.maximum(w_normal, 0.0)
                - jnp.maximum(w_color, 0.0)
            )
            wgt = jnp.where(inside, wgt, 0.0)
            sum_w = sum_w + wgt
            sum_c = sum_c + wgt[..., None] * c_p
    filtered = jnp.where(
        (sum_w > 0.0)[..., None], sum_c / jnp.maximum(sum_w, 1e-20)[..., None], img
    )
    # miss pixels pass through untouched (eaw.cu:67-71)
    return jnp.where(miss[..., None], img, filtered)


def eaw(
    img: Array,
    normal: Array,
    position: Array,
    miss: Array,
    var: Array,
    pos_radius: Array,
    params: EAWParams = EAWParams(),
) -> Array:
    """n_iterations of doubling-step EAW (renderer.cu EAW driver)."""
    for i in range(params.n_iterations):
        img = eaw_step(img, normal, position, miss, var, pos_radius, params, 1 << i)
    return img


def xbl(
    img: Array,
    normal: Array,
    position: Array,
    miss: Array,
    var: Array,
    pos_radius: Array,
    seq_shift: Array,  # (H, W, 2) per-pixel QMC shifts in [0,1)
    params: EAWParams = EAWParams(),
    taps: int = 16,
    filter_radius: float = 10.0,
    sigma: float = 10.0,
) -> Array:
    """Cross-bilateral filter with stochastic QMC disk taps.

    Reference: src/xbl.{h,cu} — `params.taps` Cranley-Patterson-shifted
    disk samples scaled by filter_radius, gaussian spatial falloff
    (sigma = 10, xbl.cu:120-146), and the same normal/position/color edge
    stops as EAW. Tap reads are flat-index gathers (post-process cost only).
    """
    h, w = img.shape[:2]
    phi_n = params.phi_normal
    phi_p = params.phi_position / jnp.maximum(pos_radius * pos_radius, 1e-12)
    phi_c = params.phi_color / jnp.maximum(1e-3, var * var)

    flat_img = img.reshape(h * w, 3)
    flat_n = normal.reshape(h * w, 3)
    flat_p = position.reshape(h * w, 3)
    flat_m = miss.reshape(h * w)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    sum_w = jnp.zeros((h, w), img.dtype)
    sum_c = jnp.zeros_like(img)
    from fermat_tpu.core.rng import hash_u32, uniform_from_bits
    from fermat_tpu.core.sampling import square_to_uniform_disk

    for s in range(taps):
        if s == 0:
            dx = jnp.zeros((h, w))
            dy = jnp.zeros((h, w))
        else:
            u = jnp.mod(
                uniform_from_bits(hash_u32(jnp.uint32(s * 2 + 1))) + seq_shift[..., 0],
                1.0,
            )
            v = jnp.mod(
                uniform_from_bits(hash_u32(jnp.uint32(s * 2 + 2))) + seq_shift[..., 1],
                1.0,
            )
            ox, oy = square_to_uniform_disk(u, v)
            dx = jnp.round(ox * filter_radius)
            dy = jnp.round(oy * filter_radius)
        px = jnp.clip(xx + dx.astype(jnp.int32), 0, w - 1)
        py = jnp.clip(yy + dy.astype(jnp.int32), 0, h - 1)
        idx = (py * w + px).reshape(-1)
        c_p = flat_img[idx].reshape(h, w, 3)
        n_p = flat_n[idx].reshape(h, w, 3)
        p_p = flat_p[idx].reshape(h, w, 3)
        m_p = flat_m[idx].reshape(h, w)
        d2 = (dx * dx + dy * dy) / (sigma * sigma)
        dc = c_p - img
        w_color = jnp.sum(dc * dc, -1) * phi_c
        w_normal = (1.0 - jnp.maximum(jnp.sum(n_p * normal, -1), 1e-8)) * phi_n
        dp = p_p - position
        w_pos = jnp.sum(dp * dp, -1) * phi_p
        wgt = jnp.exp(
            -d2
            - jnp.maximum(w_pos, 0.0)
            - jnp.maximum(w_normal, 0.0)
            - jnp.maximum(w_color, 0.0)
        )
        wgt = jnp.where(m_p, 0.0, wgt)
        sum_w = sum_w + wgt
        sum_c = sum_c + wgt[..., None] * c_p
    filtered = jnp.where(
        (sum_w > 0.0)[..., None], sum_c / jnp.maximum(sum_w, 1e-20)[..., None], img
    )
    return jnp.where(miss[..., None], img, filtered)


def denoise(
    fb,
    gbuffer_normal: Array,  # (H, W, 3)
    gbuffer_position: Array,  # (H, W, 3)
    gbuffer_miss: Array,  # (H, W) bool
    cam: Camera,
    instance: int = 0,
    w_min: float = 1e-2,
    method: str = "eaw",
) -> Array:
    """Full denoising pipeline (renderer.cu:1099-1217 kFiltered path):
    demodulate diffuse/specular by their albedo AOVs, variance-prefilter,
    filter each (EAW a-trous or XBL stochastic cross-bilateral), remodulate,
    and composite with the unfiltered direct channel.
    """
    h, w = fb.res
    params = EAWParams(phi_color=float(instance * instance + 1) / 1.0e4)
    pos_radius = _pos_radius(gbuffer_position, cam, w, h)
    if method == "xbl":
        from fermat_tpu.core.rng import hash_combine, uniform_from_bits

        pix = jnp.arange(h * w, dtype=jnp.uint32)
        s0 = uniform_from_bits(hash_combine(pix, jnp.uint32(17))).reshape(h, w)
        s1 = uniform_from_bits(hash_combine(pix, jnp.uint32(37))).reshape(h, w)
        seq_shift = jnp.stack([s0, s1], -1)

    out = fb.direct
    for img, albedo, var_idx in (
        (fb.diffuse, fb.diffuse_albedo, 1),
        (fb.specular, fb.specular_albedo, 2),
    ):
        wgt = jnp.maximum(albedo, w_min)
        demod = img / wgt
        var = filter_variance(fb.var_luminance[..., var_idx], 2)
        if method == "xbl":
            filtered = xbl(
                demod, gbuffer_normal, gbuffer_position, gbuffer_miss, var,
                pos_radius, seq_shift, params,
            )
        else:
            filtered = eaw(
                demod, gbuffer_normal, gbuffer_position, gbuffer_miss, var,
                pos_radius, params,
            )
        out = out + filtered * wgt
    return out
