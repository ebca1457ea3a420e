"""Mesh-lights tier 2: VTLs, VPL presampling, light-BVH cluster cuts.

Reference analogs:
  * `MeshVTLStorage` (src/mesh_lights.cu:632-891) — emissive triangles are
    recursively split at barycentric midpoints, prioritized by emissive
    energy (texture-weighted), into "virtual lights" of roughly uniform
    power; the RL direct-lighting sampler learns over clusters of them.
  * VPL presampling + resampling (src/mesh_lights.cu:296-380) — n_vpls
    points presampled from the emissive CDF, then resampled proportional
    to measured energy so a uniform pick is emission-proportional.
  * the light BVH + cluster cuts (src/mesh_lights.cu:400-520,
    cugar/bvh/cuda/lbvh_builder.h) — a BVH over the virtual lights whose
    area-prioritized cut defines the cluster granularity; the adaptive
    clustered-RL (src/clustered_rl_inline.h) refines/coarsens this cut.

Design: all builds are one-time host numpy. The device view is a
16-column row table per VTL (world-space sub-triangle origin/edges, normal,
radiance, conditional area pdf) so one NEE sample is a single one-hot row
fetch — no mesh gathers. VTL depth is uniform PER TRIANGLE (a triangle with
energy E gets depth ~ log4(E / E_target)), which keeps the hit->VTL map a
closed-form barycentric quadtree descent (needed for MIS pdfs of emissive
BSDF hits) instead of a per-VTL tree walk.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

D_MAX = 4  # max quadtree depth per triangle (4^4 = 256 VTLs / tri)


# ---------------------------------------------------------------------------
# Barycentric quadtree (the VTL split of mesh_lights.cu:677-690, with the
# same child corner windings: vtl0=(b0,m01,m02) vtl1=(b1,m12,m01)
# vtl2=(b2,m02,m12) vtl3=(m02,m01,m12))
# ---------------------------------------------------------------------------

def _children_np(c: np.ndarray) -> np.ndarray:
    """(N, 3, 2) corner triples -> (N, 4, 3, 2) midpoint-split children."""
    b0, b1, b2 = c[:, 0], c[:, 1], c[:, 2]
    m01 = (b0 + b1) * 0.5
    m02 = (b0 + b2) * 0.5
    m12 = (b1 + b2) * 0.5
    return np.stack(
        [
            np.stack([b0, m01, m02], 1),
            np.stack([b1, m12, m01], 1),
            np.stack([b2, m02, m12], 1),
            np.stack([m02, m01, m12], 1),
        ],
        axis=1,
    )


def leaf_corners_np(depth: int) -> np.ndarray:
    """(4^depth, 3, 2) barycentric corners of all leaves, index-ordered."""
    c = np.array([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]], np.float64)
    for _ in range(depth):
        c = _children_np(c).reshape(-1, 3, 2)
    return c


def locate(u: Array, v: Array, depth: Array, d_max: int = D_MAX) -> Array:
    """Map barycentric (u, v) to its leaf index at per-lane `depth`.

    The inverse of leaf_corners_np's ordering: at each level pick the
    child region and re-express (u, v) in that child's corner frame.
    jit-friendly: d_max static iterations with masking.
    """
    idx = jnp.zeros_like(depth)
    uu, vv = u, v
    for lvl in range(d_max):
        live = lvl < depth
        in1 = uu >= 0.5
        in2 = vv >= 0.5
        in0 = (uu + vv) <= 0.5
        c = jnp.where(in1, 1, jnp.where(in2, 2, jnp.where(in0, 0, 3)))
        # child-local coordinates matching the corner windings above
        lu = jnp.where(
            in1, 2.0 * vv,
            jnp.where(in2, 2.0 - 2.0 * uu - 2.0 * vv,
                      jnp.where(in0, 2.0 * uu, 1.0 - 2.0 * vv)),
        )
        lv = jnp.where(
            in1, 2.0 - 2.0 * uu - 2.0 * vv,
            jnp.where(in2, 2.0 * uu,
                      jnp.where(in0, 2.0 * vv, 2.0 * uu + 2.0 * vv - 1.0)),
        )
        idx = jnp.where(live, idx * 4 + c, idx)
        uu = jnp.where(live, jnp.clip(lu, 0.0, 1.0), uu)
        vv = jnp.where(live, jnp.clip(lv, 0.0, 1.0), vv)
    return idx


# ---------------------------------------------------------------------------
# VTL storage
# ---------------------------------------------------------------------------

class VTLView(NamedTuple):
    """Device view of the VTL set (MeshVTLStorage analog).

    rows columns: q0(0:3) d1(3:6) d2(6:9) n(9:12) Le(12:15) pdf_area(15),
    where a sample point is q0 + d1*s + d2*t for a uniform-triangle (s, t)
    and pdf_area is the CONDITIONAL area pdf given the VTL's cluster.
    """

    rows: Array  # (V, 16) f32
    power: Array  # (V,) f32 — normalized emission power (sums to 1)
    area: Array  # (V,) f32
    tri: Array  # (V,) i32 parent triangle
    vtl_base: Array  # (T,) i32 first VTL of tri (-1 if non-emissive)
    vtl_depth: Array  # (T,) i32 quadtree depth of tri
    leaf_slot: Array  # (V,) i32: vtl_base[tri] + local leaf idx -> storage slot
    cluster_of: Array  # (V,) i32
    cluster_offset: Array  # (C+1,) i32 (VTLs are stored in cluster order)
    seg_cdf: Array  # (V,) f32 within-cluster power cdf (inclusive)
    pdf_area: Array  # (V,) f32 conditional area pdf given cluster
    n_clusters: int  # static

    @property
    def n_vtls(self) -> int:
        return self.rows.shape[0]


class LightCutHost:
    """Host-side light BVH + current cluster cut (adaptation state).

    The BVH is a median-split tree over VTL centroids (the LBVH+cut of
    mesh_lights.cu:400-520); `cut` is a list of node ids whose VTL ranges
    partition [0, V). `adapt` refines the highest-value cut node and
    coarsens the lowest-value sibling pair, keeping the cluster count
    fixed (the AdaptiveClusteredRLStorage analog, clustered_rl_inline.h).
    """

    def __init__(self, centroids: np.ndarray, powers: np.ndarray,
                 target_clusters: int, leaf_size: int = 2):
        v = centroids.shape[0]
        self.order = np.arange(v, dtype=np.int64)
        # nodes: (start, end, left, right, parent, area)
        self.nodes: list[list] = []
        self._build(centroids, 0, v, -1, leaf_size)
        self.cut = self._initial_cut(target_clusters)
        self.powers = powers

    def _build(self, cent, start, end, parent, leaf_size) -> int:
        ids = self.order[start:end]
        lo = cent[ids].min(0)
        hi = cent[ids].max(0)
        ext = hi - lo
        area = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])
        me = len(self.nodes)
        self.nodes.append([start, end, -1, -1, parent, float(area)])
        if end - start > leaf_size:
            axis = int(np.argmax(ext))
            mid = (start + end) // 2
            sub = np.argsort(cent[ids][:, axis], kind="stable")
            self.order[start:end] = ids[sub]
            l = self._build(cent, start, mid, me, leaf_size)
            r = self._build(cent, mid, end, me, leaf_size)
            self.nodes[me][2] = l
            self.nodes[me][3] = r
        return me

    def _initial_cut(self, target: int) -> list:
        # split by surface area priority (mesh_lights.cu:446-489)
        heap = [(-self.nodes[0][5], 0)]
        cut: list[int] = []
        while heap and len(heap) + len(cut) < target:
            _, n = heapq.heappop(heap)
            l, r = self.nodes[n][2], self.nodes[n][3]
            if l < 0:
                cut.append(n)
            else:
                heapq.heappush(heap, (-self.nodes[l][5], l))
                heapq.heappush(heap, (-self.nodes[r][5], r))
        cut.extend(n for _, n in heap)
        cut.sort(key=lambda n: self.nodes[n][0])
        return cut

    @property
    def n_clusters(self) -> int:
        return len(self.cut)

    def ranges(self) -> np.ndarray:
        """(C+1,) VTL offsets of the current cut (sorted by start)."""
        starts = [self.nodes[n][0] for n in self.cut]
        return np.asarray(starts + [self.nodes[0][1]], np.int64)

    def adapt(self, value: np.ndarray):
        """One refine+coarsen step driven by learned per-cluster value.

        Splits the cut node with the highest value (if splittable) and
        merges the sibling pair with the lowest combined value, keeping
        len(cut) constant. Returns the (C, C) Q-remap matrix M with
        q_new = q_old @ M.T, or None if no change was possible.
        """
        c = len(self.cut)
        pos = {n: i for i, n in enumerate(self.cut)}
        # candidate merges: sibling pairs both in the cut
        merges = []
        for i, n in enumerate(self.cut):
            p = self.nodes[n][4]
            if p >= 0 and self.nodes[p][2] == n:  # n is a left child
                sib = self.nodes[p][3]
                if sib in pos:
                    merges.append((value[i] + value[pos[sib]], p, n, sib))
        splits = [
            (value[i], n) for i, n in enumerate(self.cut)
            if self.nodes[n][2] >= 0
        ]
        if not merges or not splits:
            return None
        merges.sort(key=lambda t: t[0])
        splits.sort(key=lambda t: -t[0])
        mval, mparent, ml, mr = merges[0]
        sval, snode = splits[0]
        if snode in (ml, mr) or sval <= mval * 2.0:
            return None  # not profitable
        new_cut = [n for n in self.cut if n not in (ml, mr, snode)]
        new_cut.extend([mparent, self.nodes[snode][2], self.nodes[snode][3]])
        new_cut.sort(key=lambda n: self.nodes[n][0])
        # Q remap: children of the split inherit its row; the merged node
        # averages its children's rows
        m = np.zeros((len(new_cut), c), np.float32)
        for j, n in enumerate(new_cut):
            if n == mparent:
                m[j, pos[ml]] = 0.5
                m[j, pos[mr]] = 0.5
            elif n in (self.nodes[snode][2], self.nodes[snode][3]):
                m[j, pos[snode]] = 1.0
            else:
                m[j, pos[n]] = 1.0
        self.cut = new_cut
        return m


def build_vtls(
    mesh_view,
    target_clusters: int = 64,
    n_target_vtls: int = 1024,
    tri_energy: Optional[np.ndarray] = None,
    leaf_energy: Optional[callable] = None,
) -> tuple:
    """Build the VTL set + light-BVH cluster cut. Returns (VTLView, LightCutHost).

    tri_energy: optional (T,) emissive energies (texture-integrated); the
    default uses material luminance x area. leaf_energy(tri_ids, corners)
    optionally refines per-leaf energies (texture integrals per sub-tri).
    """
    p0 = np.stack([np.asarray(mesh_view.p0.x), np.asarray(mesh_view.p0.y),
                   np.asarray(mesh_view.p0.z)], 1)
    e1 = np.stack([np.asarray(mesh_view.e1.x), np.asarray(mesh_view.e1.y),
                   np.asarray(mesh_view.e1.z)], 1)
    e2 = np.stack([np.asarray(mesh_view.e2.x), np.asarray(mesh_view.e2.y),
                   np.asarray(mesh_view.e2.z)], 1)
    gn = np.stack([np.asarray(mesh_view.gn.x), np.asarray(mesh_view.gn.y),
                   np.asarray(mesh_view.gn.z)], 1)
    mid = np.asarray(mesh_view.material_id)
    em = mesh_view.materials.emissive
    em_np = np.stack([np.asarray(em.x), np.asarray(em.y), np.asarray(em.z)], 1)
    le_tri = em_np[mid]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    t = p0.shape[0]

    if tri_energy is None:
        lum = le_tri @ np.array([0.2126, 0.7152, 0.0722])
        tri_energy = lum * area
    emissive = np.nonzero(tri_energy > 0)[0]

    vtl_base = np.full(t, -1, np.int32)
    vtl_depth = np.zeros(t, np.int32)
    if emissive.size == 0:
        z = jnp.zeros(0, jnp.float32)
        view = VTLView(
            rows=jnp.zeros((0, 16), jnp.float32), power=z, area=z,
            tri=jnp.zeros(0, jnp.int32), vtl_base=jnp.asarray(vtl_base),
            vtl_depth=jnp.asarray(vtl_depth),
            leaf_slot=jnp.zeros(0, jnp.int32),
            cluster_of=jnp.zeros(0, jnp.int32),
            cluster_offset=jnp.zeros(target_clusters + 1, jnp.int32),
            seg_cdf=z, pdf_area=z, n_clusters=target_clusters,
        )
        return view, None

    # per-tri quadtree depth: leaves distributed ~ proportional to energy
    e_tot = tri_energy[emissive].sum()
    e_target = e_tot / max(n_target_vtls, 1)
    with np.errstate(divide="ignore"):
        d = np.floor(np.log(np.maximum(tri_energy[emissive] / e_target, 1e-30))
                     / np.log(4.0) + 0.5)
    depth = np.clip(d, 0, D_MAX).astype(np.int32)
    vtl_depth[emissive] = depth

    # enumerate leaves per depth class (vectorized per depth value)
    tri_ids, corners = [], []
    for dv in range(D_MAX + 1):
        tris_d = emissive[depth == dv]
        if tris_d.size == 0:
            continue
        lc = leaf_corners_np(dv)  # (L, 3, 2)
        tri_ids.append(np.repeat(tris_d, lc.shape[0]))
        corners.append(np.tile(lc, (tris_d.size, 1, 1)))
    tri_ids = np.concatenate(tri_ids)
    corners = np.concatenate(corners).astype(np.float64)  # (V, 3, 2)
    v = tri_ids.size

    # leaf index within each tri follows leaf_corners_np ordering; record
    # bases by re-sorting (tri, local) lexicographically
    order0 = np.lexsort((np.arange(v), tri_ids))
    tri_ids = tri_ids[order0]
    corners = corners[order0]
    first = np.searchsorted(tri_ids, emissive)
    vtl_base[emissive] = first.astype(np.int32)

    # geometry rows in the PARENT tri frame: q0 = p0 + E*(c0), d1 = E*(c1-c0)
    def world(c):
        return (p0[tri_ids] + e1[tri_ids] * c[:, :1] + e2[tri_ids] * c[:, 1:2])

    q0 = world(corners[:, 0])
    w1 = world(corners[:, 1])
    w2 = world(corners[:, 2])
    d1 = w1 - q0
    d2 = w2 - q0
    leaf_area = 0.5 * np.linalg.norm(np.cross(d1, d2), axis=1)

    if leaf_energy is not None:
        powers = np.asarray(leaf_energy(tri_ids, corners), np.float64)
    else:
        lum = le_tri[tri_ids] @ np.array([0.2126, 0.7152, 0.0722])
        powers = lum * leaf_area
    powers = np.maximum(powers, 1e-30 * powers.max())
    powers = powers / powers.sum()

    # light BVH over leaf centroids + area-prioritized cut
    cent = (q0 + w1 + w2) / 3.0
    cut = LightCutHost(cent, powers, target_clusters)
    perm = cut.order  # VTLs in BVH order
    inv = np.empty(v, np.int64)
    inv[perm] = np.arange(v)

    # permute everything into BVH order; vtl_base/local-index mapping now
    # goes through `leaf_slot`: slot = inv[base + local]
    tri_ids_s = tri_ids[perm]
    q0, d1, d2 = q0[perm], d1[perm], d2[perm]
    leaf_area_s = leaf_area[perm]
    powers_s = powers[perm]

    ranges = cut.ranges()
    c_count = len(cut.cut)
    cluster_of = np.zeros(v, np.int32)
    seg_cdf = np.zeros(v, np.float32)
    pdf_area = np.zeros(v, np.float32)
    for ci in range(c_count):
        a, b = int(ranges[ci]), int(ranges[ci + 1])
        cluster_of[a:b] = ci
        w = powers_s[a:b]
        ws = max(w.sum(), 1e-30)
        seg_cdf[a:b] = np.cumsum(w) / ws
        pdf_area[a:b] = (w / ws) / np.maximum(leaf_area_s[a:b], 1e-20)

    n_f = gn[tri_ids_s]
    le_f = le_tri[tri_ids_s]
    rows = np.concatenate(
        [q0, d1, d2, n_f, le_f, pdf_area[:, None]], axis=1
    ).astype(np.float32)

    # pad cluster_offset to target_clusters+1 (cut may be smaller)
    offs = np.full(target_clusters + 1, int(ranges[-1]), np.int64)
    offs[: c_count + 1] = ranges

    view = VTLView(
        rows=jnp.asarray(rows),
        power=jnp.asarray(powers_s.astype(np.float32)),
        area=jnp.asarray(leaf_area_s.astype(np.float32)),
        tri=jnp.asarray(tri_ids_s.astype(np.int32)),
        vtl_base=jnp.asarray(vtl_base),
        vtl_depth=jnp.asarray(vtl_depth),
        leaf_slot=jnp.asarray(inv.astype(np.int32)),
        cluster_of=jnp.asarray(cluster_of),
        cluster_offset=jnp.asarray(offs.astype(np.int32)),
        seg_cdf=jnp.asarray(seg_cdf),
        pdf_area=jnp.asarray(pdf_area),
        n_clusters=target_clusters,
    )
    return view, cut


def reclustered(view: VTLView, cut: LightCutHost) -> VTLView:
    """Rebuild the cluster-dependent arrays after a cut adaptation."""
    v = view.n_vtls
    ranges = cut.ranges()
    c_count = len(cut.cut)
    powers_s = np.asarray(view.power, np.float64)
    leaf_area_s = np.asarray(view.area, np.float64)
    cluster_of = np.zeros(v, np.int32)
    seg_cdf = np.zeros(v, np.float32)
    pdf_area = np.zeros(v, np.float32)
    for ci in range(c_count):
        a, b = int(ranges[ci]), int(ranges[ci + 1])
        cluster_of[a:b] = ci
        w = powers_s[a:b]
        ws = max(w.sum(), 1e-30)
        seg_cdf[a:b] = np.cumsum(w) / ws
        pdf_area[a:b] = (w / ws) / np.maximum(leaf_area_s[a:b], 1e-20)
    offs = np.full(view.n_clusters + 1, v, np.int64)
    offs[: c_count + 1] = ranges
    rows = np.asarray(view.rows).copy()
    rows[:, 15] = pdf_area
    return view._replace(
        rows=jnp.asarray(rows),
        cluster_of=jnp.asarray(cluster_of),
        cluster_offset=jnp.asarray(offs.astype(np.int32)),
        seg_cdf=jnp.asarray(seg_cdf),
        pdf_area=jnp.asarray(pdf_area),
    )


# ---------------------------------------------------------------------------
# Textured-emitter energies + VPL presampling
# (src/mesh_lights.cu:158-380: texture-integrated CDF weights, n_vpls
#  presample + emission-proportional resampling)
# ---------------------------------------------------------------------------

def _host_tex_lookup(images, tex_idx: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> np.ndarray:
    """(N, 3) nearest-texel host lookup; tex_idx < 0 -> white."""
    out = np.ones((tex_idx.shape[0], 3), np.float64)
    for ti in np.unique(tex_idx):
        if ti < 0 or ti >= len(images):
            continue
        img = np.asarray(images[ti], np.float64)
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        h, w = img.shape[:2]
        m = tex_idx == ti
        x = np.minimum((np.mod(u[m], 1.0) * w).astype(np.int64), w - 1)
        y = np.minimum((np.mod(v[m], 1.0) * h).astype(np.int64), h - 1)
        out[m] = img[y, x, :3]
    return out


def textured_tri_energies(
    mesh_view, images, n_samples: int = 10, seed: int = 1351
) -> np.ndarray:
    """(T,) emissive energies with the texture integral folded in — the
    CDF weights of mesh_lights.cu:158-285 (MC texture estimate x area)."""
    mid = np.asarray(mesh_view.material_id)
    em = mesh_view.materials.emissive
    em_np = np.stack([np.asarray(em.x), np.asarray(em.y), np.asarray(em.z)], 1)
    emap = np.asarray(mesh_view.materials.emissive_map)
    e1 = np.stack([np.asarray(mesh_view.e1.x), np.asarray(mesh_view.e1.y),
                   np.asarray(mesh_view.e1.z)], 1)
    e2 = np.stack([np.asarray(mesh_view.e2.x), np.asarray(mesh_view.e2.y),
                   np.asarray(mesh_view.e2.z)], 1)
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    le = em_np[mid]
    lum = le @ np.array([0.2126, 0.7152, 0.0722])
    energy = lum * area
    tmap = emap[mid]
    tex_tris = np.nonzero((energy > 0) & (tmap >= 0))[0]
    if tex_tris.size == 0 or not images:
        return energy
    uv0 = np.asarray(mesh_view.uv0)
    uv1 = np.asarray(mesh_view.uv1)
    uv2 = np.asarray(mesh_view.uv2)
    rng = np.random.default_rng(seed)
    k = n_samples
    t = tex_tris.size
    s = rng.random((t, k))
    r = rng.random((t, k))
    flip = s + r > 1
    s = np.where(flip, 1 - s, s)
    r = np.where(flip, 1 - r, r)
    w = 1.0 - s - r
    uvs = (uv0[tex_tris][:, None] * w[..., None]
           + uv1[tex_tris][:, None] * s[..., None]
           + uv2[tex_tris][:, None] * r[..., None])
    tex = np.repeat(tmap[tex_tris], k)
    rgb = _host_tex_lookup(images, tex, uvs[..., 0].ravel(), uvs[..., 1].ravel())
    avg = rgb.reshape(t, k, 3).mean(1)
    lum_t = (le[tex_tris] * avg) @ np.array([0.2126, 0.7152, 0.0722])
    energy[tex_tris] = lum_t * area[tex_tris]
    return energy


class VPLView(NamedTuple):
    """Presampled VPL set (src/mesh_lights.cu:296-380): M points
    distributed proportional to emission, so a uniform pick is an
    emission-proportional light sample.

    rows columns: pos(0:3) n(3:6) Le(6:9) pdf_area(9) tri(10).
    """

    rows: Array  # (M, 11) f32
    norm: Array  # () f32 — area integral of emission luminance
    count: int  # static

    def sample(self, u: Array):
        """Uniform VPL pick -> (pos, n, Le, pdf_area, tri)."""
        from fermat_tpu.core.math import Vec3 as _V
        from fermat_tpu.ops.gather import gather_rows

        m = self.rows.shape[0]  # static (count is a traced leaf under jit)
        k = jnp.minimum((u * m).astype(jnp.int32), m - 1)
        r = gather_rows(self.rows, k)
        vec = lambda c0: _V(r[:, c0], r[:, c0 + 1], r[:, c0 + 2])
        return vec(0), vec(3), vec(6), r[:, 9], r[:, 10].astype(jnp.int32)


def build_vpls(
    mesh_view,
    n_vpls: int = 256,
    tri_energy: Optional[np.ndarray] = None,
    images=None,
    seed: int = 1351,
) -> Optional[VPLView]:
    """Presample + resample VPLs (mesh_lights.cu:296-380)."""
    if tri_energy is None:
        tri_energy = textured_tri_energies(mesh_view, images or [])
    total = tri_energy.sum()
    if total <= 0:
        return None
    p0 = np.stack([np.asarray(mesh_view.p0.x), np.asarray(mesh_view.p0.y),
                   np.asarray(mesh_view.p0.z)], 1)
    e1 = np.stack([np.asarray(mesh_view.e1.x), np.asarray(mesh_view.e1.y),
                   np.asarray(mesh_view.e1.z)], 1)
    e2 = np.stack([np.asarray(mesh_view.e2.x), np.asarray(mesh_view.e2.y),
                   np.asarray(mesh_view.e2.z)], 1)
    gn = np.stack([np.asarray(mesh_view.gn.x), np.asarray(mesh_view.gn.y),
                   np.asarray(mesh_view.gn.z)], 1)
    uv0 = np.asarray(mesh_view.uv0)
    uv1 = np.asarray(mesh_view.uv1)
    uv2 = np.asarray(mesh_view.uv2)
    mid = np.asarray(mesh_view.material_id)
    em = mesh_view.materials.emissive
    em_np = np.stack([np.asarray(em.x), np.asarray(em.y), np.asarray(em.z)], 1)
    emap = np.asarray(mesh_view.materials.emissive_map)
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)

    rng = np.random.default_rng(seed)
    cdf = np.cumsum(tri_energy) / total
    # stratified presample from the triangle CDF (pdf in area measure)
    r = (np.arange(n_vpls) + rng.random(n_vpls)) / n_vpls
    tri = np.minimum(np.searchsorted(cdf, r), tri_energy.size - 1)
    u = rng.random(n_vpls)
    v = rng.random(n_vpls)
    flip = u + v > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pdf_area = (tri_energy[tri] / total) / np.maximum(area[tri], 1e-20)
    pos = p0[tri] + e1[tri] * u[:, None] + e2[tri] * v[:, None]
    uvs = (uv0[tri] * (1 - u - v)[:, None] + uv1[tri] * u[:, None]
           + uv2[tri] * v[:, None])
    le = em_np[mid[tri]]
    if images:
        tex = emap[mid[tri]]
        le = le * _host_tex_lookup(images, tex, uvs[:, 0], uvs[:, 1])
    lum = le @ np.array([0.2126, 0.7152, 0.0722])
    e_over_pdf = lum / np.maximum(pdf_area, 1e-30)
    norm = e_over_pdf.mean()  # MC estimate of the emission area integral
    if norm <= 0:
        return None
    # resample proportional to measured energy -> uniform pick is
    # emission-proportional; each VPL's density is lum/norm in area measure
    w = e_over_pdf / np.maximum(e_over_pdf.sum(), 1e-30)
    wcdf = np.cumsum(w)
    r2 = (np.arange(n_vpls) + rng.random(n_vpls)) / n_vpls
    pick = np.minimum(np.searchsorted(wcdf, r2), n_vpls - 1)
    rows = np.concatenate(
        [pos[pick], gn[tri[pick]], le[pick],
         (lum[pick] / norm)[:, None], tri[pick][:, None].astype(np.float64)],
        axis=1,
    ).astype(np.float32)
    return VPLView(rows=jnp.asarray(rows), norm=jnp.float32(norm),
                   count=n_vpls)
