"""Texture storage + mipmapped sampling.

Reference: src/texture.h:53-110 (TextureStorage/MipMapStorage),
src/texture_view.h (TextureView/MipMapView), loading at renderer.cu:784-882
(TGA/PFM -> float4 mip chains), and the ray-cone LOD selection of the PT
(pathtracer_core.h ray-cone footprint tracking).

Design: XLA needs static shapes, so all mip levels of all textures are
packed into ONE flat (S, 4) texel array plus a small (n_tex, n_levels)
offset/size table. A lookup is 4 texel gathers (bilinear) at a computed
level — the only irreducibly-gathering op in the renderer (the atlas is far
too large for one-hot matmuls).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.core.math import Vec3

Array = jax.Array

MAX_LEVELS = 12  # up to 2048x2048


def _mip_chain(img: np.ndarray) -> List[np.ndarray]:
    """Full mip pyramid by 2x2 box filter (MipMapStorage::generate_mips)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    if img.shape[2] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
    # pad to pow2
    h, w = img.shape[:2]
    hp = 1 << max(int(np.ceil(np.log2(max(h, 1)))), 0)
    wp = 1 << max(int(np.ceil(np.log2(max(w, 1)))), 0)
    if (hp, wp) != (h, w):
        yi = np.minimum(np.arange(hp) * h // hp, h - 1)
        xi = np.minimum(np.arange(wp) * w // wp, w - 1)
        img = img[yi][:, xi]
    chain = [img]
    while img.shape[0] > 1 or img.shape[1] > 1:
        # reduce each axis independently: a joint (h2,2,w2,2) reshape
        # breaks on non-square chains once one axis hits 1 (e.g. 1x2)
        if img.shape[0] > 1:
            h2 = img.shape[0] // 2
            img = img[: h2 * 2].reshape(h2, 2, img.shape[1], 4).mean(1)
        if img.shape[1] > 1:
            w2 = img.shape[1] // 2
            img = img[:, : w2 * 2].reshape(img.shape[0], w2, 2, 4).mean(2)
        chain.append(img.astype(np.float32))
    return chain[:MAX_LEVELS]


class TextureAtlas(NamedTuple):
    """Packed mip atlas (device)."""

    texels: Array  # (S, 4) f32
    offset: Array  # (n_tex, MAX_LEVELS) i32 — start index of each level
    width: Array  # (n_tex, MAX_LEVELS) i32
    height: Array  # (n_tex, MAX_LEVELS) i32
    n_levels: Array  # (n_tex,) i32
    # (S,) u32 RGBA8-packed texels, present iff EVERY source image is
    # 8-bit-exact (TGA path). One gathered element per tap instead of a
    # 4-wide row: a quarter of the gathered elements, losslessly. None =
    # float sources (PFM/HDR), row-gather fallback.
    packed: Optional[Array] = None
    # (S, 4) u32 wrap-aware bilinear QUAD mirror: column k of row
    # o + y*w + x holds packed[(x, y)], [(x+1)%w, y], [(x, (y+1)%h)],
    # [(x+1)%w, (y+1)%h]. A bilinear quad becomes ONE row gather — the
    # round-5 segment profile showed the four separate 1-D tap gathers
    # fusing into ~10-32 ms kLoop fusions EACH at 1.43M lanes.
    packed_q: Optional[Array] = None

    @property
    def count(self) -> int:
        return self.n_levels.shape[0]

    @staticmethod
    def build(images: List[np.ndarray]) -> "TextureAtlas":
        """Pack a list of HxWx{1,3,4} float images (empty list -> 1 white 1x1)."""
        if not images:
            images = [np.ones((1, 1, 4), np.float32)]
        texels = []
        offs = np.zeros((len(images), MAX_LEVELS), np.int64)
        ws = np.ones((len(images), MAX_LEVELS), np.int64)
        hs = np.ones((len(images), MAX_LEVELS), np.int64)
        nl = np.zeros(len(images), np.int64)
        cursor = 0
        for ti, img in enumerate(images):
            chain = _mip_chain(img)
            nl[ti] = len(chain)
            for li, level in enumerate(chain):
                offs[ti, li] = cursor
                hs[ti, li] = level.shape[0]
                ws[ti, li] = level.shape[1]
                texels.append(level.reshape(-1, 4))
                cursor += level.shape[0] * level.shape[1]
            # clamp the tail so out-of-range lods read the last level
            for li in range(len(chain), MAX_LEVELS):
                offs[ti, li] = offs[ti, len(chain) - 1]
                hs[ti, li] = hs[ti, len(chain) - 1]
                ws[ti, li] = ws[ti, len(chain) - 1]
        j = jnp.asarray
        flat = np.concatenate(texels, 0)
        # RGBA8 packing (lossless only for 8-bit sources; mip levels are
        # box-filtered f32 means, so require 8-bit-exactness per LEVEL)
        # 8-bit detection on the SOURCE levels only (mips are box-filter
        # means); when all sources are 8-bit the whole chain quantizes to
        # RGBA8 — standard GPU mip storage, and it keeps the float rows
        # and the packed taps bit-consistent
        lvl0 = np.concatenate([_mip_chain(im)[0].reshape(-1, 4)
                               for im in images], 0)
        q0 = np.round(np.clip(lvl0, 0.0, 1.0) * 255.0)
        sources_8bit = np.abs(lvl0 - q0 / 255.0).max() \
            <= (0.5 / 255.0) * 1e-3 + 1e-6
        if sources_8bit:
            flat = (np.round(np.clip(flat, 0.0, 1.0) * 255.0) / 255.0
                    ).astype(np.float32)
        q = np.round(np.clip(flat, 0.0, 1.0) * 255.0)
        packed = None
        packed_q = None
        if np.abs(flat - q / 255.0).max() <= (0.5 / 255.0) * 1e-3 + 1e-6:
            qi = q.astype(np.uint32)
            pk = (qi[:, 0] | (qi[:, 1] << 8) | (qi[:, 2] << 16)
                  | (qi[:, 3] << 24)).astype(np.uint32)
            packed = j(pk)
            # wrap-aware quad mirror per level: the four corners of the
            # bilinear quad anchored at (x0, y0) become one 16-B row
            pq = np.stack([pk, pk, pk, pk], axis=1)
            for ti in range(len(images)):
                for li in range(int(nl[ti])):
                    o, wl, hl = int(offs[ti, li]), int(ws[ti, li]), int(hs[ti, li])
                    lvl = pk[o:o + wl * hl].reshape(hl, wl)
                    pq[o:o + wl * hl, 1] = np.roll(lvl, -1, axis=1).reshape(-1)
                    pq[o:o + wl * hl, 2] = np.roll(lvl, -1, axis=0).reshape(-1)
                    pq[o:o + wl * hl, 3] = np.roll(
                        np.roll(lvl, -1, axis=0), -1, axis=1).reshape(-1)
            packed_q = j(pq)
        return TextureAtlas(
            texels=j(flat),
            offset=j(offs.astype(np.int32)),
            width=j(ws.astype(np.int32)),
            height=j(hs.astype(np.int32)),
            n_levels=j(nl.astype(np.int32)),
            packed=packed,
            packed_q=packed_q,
        )

    def _level_fetch(self, tex: Array, level: Array, u: Array, v: Array):
        """Bilinear fetch at an integer mip level; wrap addressing."""
        off = self.offset[tex, level]
        w = self.width[tex, level]
        h = self.height[tex, level]
        fu = u * w.astype(jnp.float32) - 0.5
        fv = v * h.astype(jnp.float32) - 0.5
        x0 = jnp.floor(fu)
        y0 = jnp.floor(fv)
        tx = fu - x0
        ty = fv - y0
        x0i = jnp.mod(x0.astype(jnp.int32), w)
        y0i = jnp.mod(y0.astype(jnp.int32), h)
        x1i = jnp.mod(x0i + 1, w)
        y1i = jnp.mod(y0i + 1, h)

        if self.packed is not None:
            inv255 = np.float32(1.0 / 255.0)

            def tap(xi, yi):
                p = self.packed[off + yi * w + xi]  # (N,) u32 — 1 elem/tap
                return jnp.stack(
                    [(p & 0xFF).astype(jnp.float32) * inv255,
                     ((p >> 8) & 0xFF).astype(jnp.float32) * inv255,
                     ((p >> 16) & 0xFF).astype(jnp.float32) * inv255,
                     ((p >> 24) & 0xFF).astype(jnp.float32) * inv255],
                    axis=-1)
        else:
            def tap(xi, yi):
                return self.texels[off + yi * w + xi]  # (N, 4)

        c00 = tap(x0i, y0i)
        c10 = tap(x1i, y0i)
        c01 = tap(x0i, y1i)
        c11 = tap(x1i, y1i)
        tx = tx[:, None]
        ty = ty[:, None]
        return (
            c00 * (1 - tx) * (1 - ty)
            + c10 * tx * (1 - ty)
            + c01 * (1 - tx) * ty
            + c11 * tx * ty
        )

    def sample(self, tex: Array, u: Array, v: Array, lod: Array = None) -> Array:
        """Trilinear (mipmapped bilinear) sample; tex < 0 returns white.

        u, v in [0,1] (wrapped); lod in mip-level units (None -> level 0).
        Returns (N, 4) RGBA.
        """
        if lod is None and self.packed_q is not None:
            # LOD-None sampling is bilinear level 0 — identical math to
            # sample_bilinear0, which takes the one-gather quad path
            return self.sample_bilinear0(tex, u, v)
        tex_c = jnp.maximum(tex, 0)
        max_l = (self.n_levels[tex_c] - 1).astype(jnp.float32)
        if lod is None:
            rgba = self._level_fetch(tex_c, jnp.zeros_like(tex_c), u, v)
        else:
            l = jnp.clip(lod, 0.0, max_l)
            l0 = jnp.floor(l).astype(jnp.int32)
            l1 = jnp.minimum(l0 + 1, max_l.astype(jnp.int32))
            f = (l - l0)[:, None]
            rgba = (
                self._level_fetch(tex_c, l0, u, v) * (1 - f)
                + self._level_fetch(tex_c, l1, u, v) * f
            )
        white = jnp.ones_like(rgba)
        return jnp.where((tex < 0)[:, None], white, rgba)

    def sample_bilinear0(self, tex: Array, u: Array, v: Array) -> Array:
        """Bilinear at mip level 0 — EXACT reference parity
        (bilinear_texture_lookup, src/texture_view.h:143-179: the
        reference's PT shading always samples LOD 0; its mip chain exists
        but shading never selects levels). Fast path for 8-bit atlases:
        level-0 metadata rides a gather_rows fetch and the whole quad is
        ONE (S, 4) u32 row gather on the wrap-aware quad mirror."""
        tex_c = jnp.maximum(tex, 0)
        if self.packed_q is None:
            rgba = self._level_fetch(tex_c, jnp.zeros_like(tex_c), u, v)
            white = jnp.ones_like(rgba)
            return jnp.where((tex < 0)[:, None], white, rgba)
        from fermat_tpu.ops.gather import gather_rows

        meta = jnp.stack(
            [self.offset[:, 0].astype(jnp.float32),
             self.width[:, 0].astype(jnp.float32),
             self.height[:, 0].astype(jnp.float32)], axis=1)
        m = gather_rows(meta, tex_c)
        off = m[:, 0].astype(jnp.int32)
        w = m[:, 1].astype(jnp.int32)
        h = m[:, 2].astype(jnp.int32)
        fu = u * m[:, 1] - 0.5
        fv = v * m[:, 2] - 0.5
        x0 = jnp.floor(fu)
        y0 = jnp.floor(fv)
        tx = (fu - x0)[:, None]
        ty = (fv - y0)[:, None]
        x0i = jnp.mod(x0.astype(jnp.int32), w)
        y0i = jnp.mod(y0.astype(jnp.int32), h)

        inv255 = np.float32(1.0 / 255.0)

        def unpack(pv):
            return jnp.stack(
                [(pv & 0xFF).astype(jnp.float32) * inv255,
                 ((pv >> 8) & 0xFF).astype(jnp.float32) * inv255,
                 ((pv >> 16) & 0xFF).astype(jnp.float32) * inv255,
                 ((pv >> 24) & 0xFF).astype(jnp.float32) * inv255],
                axis=-1)

        quad = self.packed_q[off + y0i * w + x0i]  # (N, 4) u32 — 1 gather
        c00 = unpack(quad[:, 0])
        c10 = unpack(quad[:, 1])
        c01 = unpack(quad[:, 2])
        c11 = unpack(quad[:, 3])
        rgba = (c00 * (1 - tx) + c10 * tx) * (1 - ty) \
            + (c01 * (1 - tx) + c11 * tx) * ty
        white = jnp.ones_like(rgba)
        return jnp.where((tex < 0)[:, None], white, rgba)


_ORIG_ATLAS_REPLACE = TextureAtlas._replace


def _atlas_replace(self, **kw):
    """NamedTuple._replace override (attached post-class: typing forbids
    in-body overrides). Replacing `texels` drops the RGBA8 mirror
    (packed/packed_q) unless new ones are passed too: the mirror is a
    QUANTIZED COPY of the texels built at atlas time, and a stale mirror
    silently wins over updated texels in every fetch — zeroing texture
    gradients and ignoring texel optimization steps (the differentiable-
    texture train path does exactly this replace). Sampling falls back to
    the float row-gather path when the mirror is absent."""
    if "texels" in kw:
        # the mirror survives only when BOTH halves are explicitly
        # re-supplied; a lone packed (or packed_q) would pair fresh taps
        # with stale quad-neighbor taps in sample_bilinear0
        if ("packed" in kw) != ("packed_q" in kw):
            raise ValueError(
                "TextureAtlas._replace: packed and packed_q must be "
                "replaced together (the RGBA8 mirror is a pair)"
            )
        if "packed" not in kw:
            kw["packed"] = None
            kw["packed_q"] = None
    return _ORIG_ATLAS_REPLACE(self, **kw)


TextureAtlas._replace = _atlas_replace


def modulate(color: Vec3, rgba: Array) -> Vec3:
    return Vec3(color.x * rgba[:, 0], color.y * rgba[:, 1], color.z * rgba[:, 2])
