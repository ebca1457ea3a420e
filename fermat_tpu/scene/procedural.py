"""Procedural test scenes.

The classic Cornell box built in code (mirrors models/CornellBox/CornellBox-JP
geometry/materials closely enough for regression tests without file IO), plus
random triangle soups for BVH stress tests and a parametric "big room" scene
for bathroom2-class benchmarking when the reference .obj assets are absent
(the bundled bathroom2/bathroom.fa references bathroom.obj which is not
shipped in the reference checkout).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from fermat_tpu.core.camera import Camera
from fermat_tpu.scene.materials import HostMaterial
from fermat_tpu.scene.mesh import MeshStorage


def _quad(vs: List, tris: List, mats: List, a, b, c, d, mat_id: int,
          uvs: Optional[List] = None):
    i = len(vs)
    vs += [a, b, c, d]
    tris += [[i, i + 1, i + 2], [i, i + 2, i + 3]]
    mats += [mat_id, mat_id]
    if uvs is not None:
        # each quad spans the full [0,1]^2 uv square (vertex-parallel uvs)
        uvs += [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]


def _box(vs, tris, mats, lo, hi, mat_id, rot_y: float = 0.0, center=None,
         uvs: Optional[List] = None):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    corners = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1],
            [x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    if rot_y != 0.0:
        cx, cz = center if center is not None else ((x0 + x1) / 2, (z0 + z1) / 2)
        c, s = np.cos(rot_y), np.sin(rot_y)
        x = corners[:, 0] - cx
        z = corners[:, 2] - cz
        corners[:, 0] = c * x + s * z + cx
        corners[:, 2] = -s * x + c * z + cz
    idx = [
        (0, 1, 5, 4), (2, 3, 7, 6), (1, 2, 6, 5), (3, 0, 4, 7), (4, 5, 6, 7), (3, 2, 1, 0),
    ]
    for q in idx:
        _quad(vs, tris, mats, *[corners[j] for j in q], mat_id, uvs=uvs)


def cornell_box(
    light_scale: float = 1.0,
    glossy_boxes: bool = False,
    light_size: float = 1.0,
) -> MeshStorage:
    """A Cornell box: red/green walls, white floor/ceiling/back, two boxes,
    area light in the ceiling. Matches CornellBox-JP.mtl albedos."""
    vs: List = []
    tris: List = []
    mats: List[int] = []
    uvs: List = []

    WHITE, RED, GREEN, LIGHT, BOX = 0, 1, 2, 3, 4
    # floor / ceiling / back wall (white)
    _quad(vs, tris, mats, [-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1], WHITE, uvs=uvs)
    _quad(vs, tris, mats, [-1, 2, 1], [-1, 2, -1], [1, 2, -1], [1, 2, 1], WHITE, uvs=uvs)
    _quad(vs, tris, mats, [-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1], WHITE, uvs=uvs)
    # left (red) / right (green) — CornellBox-JP convention
    _quad(vs, tris, mats, [-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1], RED, uvs=uvs)
    _quad(vs, tris, mats, [1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1], GREEN, uvs=uvs)
    # ceiling light (slightly below ceiling, facing down); light_size scales
    # the quad about its center (test scenes use larger emitters to condition
    # BSDF-sampling estimators)
    lq = np.array(
        [[-0.24, 1.98, 0.22], [-0.24, 1.98, -0.16], [0.23, 1.98, -0.16], [0.23, 1.98, 0.22]],
        np.float32,
    )
    lc = lq.mean(0)
    lq[:, [0, 2]] = lc[[0, 2]] + (lq[:, [0, 2]] - lc[[0, 2]]) * min(light_size, 3.9)
    _quad(vs, tris, mats, lq[0], lq[1], lq[2], lq[3], LIGHT, uvs=uvs)
    # short box and tall box
    _box(vs, tris, mats, (0.05, 0.0, 0.0), (0.65, 0.6, 0.55), BOX, rot_y=-0.29, uvs=uvs)
    _box(vs, tris, mats, (-0.65, 0.0, -0.65), (-0.05, 1.2, -0.05), BOX, rot_y=0.31, uvs=uvs)

    def mk(name, kd, ke=(0, 0, 0), ks=(0, 0, 0), ns=0.0):
        m = HostMaterial(name)
        m.diffuse = kd
        m.emissive = ke
        m.specular = ks
        m.phong_exponent = ns
        return m

    materials = [
        mk("white", (0.725, 0.71, 0.68)),
        mk("red", (0.63, 0.065, 0.05)),
        mk("green", (0.14, 0.45, 0.091)),
        mk("light", (0.78, 0.78, 0.78), ke=tuple(17.0 * light_scale for _ in range(3))),
        mk(
            "box",
            (0.725, 0.71, 0.68),
            ks=(0.5, 0.5, 0.5) if glossy_boxes else (0, 0, 0),
            ns=40.0 if glossy_boxes else 0.0,
        ),
    ]

    t = np.asarray(tris, np.int32)
    return MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uvs=np.asarray(uvs, np.float32),
        uv_indices=t.copy(),  # uvs are vertex-parallel
        material_ids=np.asarray(mats, np.int32),
        materials=materials,
        group_names=["cornell"],
        group_offsets=np.asarray([0, t.shape[0]], np.int32),
    )


def cornell_camera() -> Camera:
    """models/CornellBox/camera-frontal.txt."""
    return Camera.create((0, 1.3, 1.5), (-0.01, 0.945, -0.025), (0, 1, 0), 1.81)


def random_soup(n_tris: int, seed: int = 0, extent: float = 10.0) -> MeshStorage:
    """Random triangle soup for BVH stress tests (lbvh_test.cu analog)."""
    r = np.random.default_rng(seed)
    centers = (r.random((n_tris, 3), dtype=np.float32) - 0.5) * extent
    offs = (r.random((n_tris, 2, 3), dtype=np.float32) - 0.5) * (
        extent * 2.0 / max(n_tris ** (1 / 3), 1.0)
    )
    v0 = centers
    v1 = centers + offs[:, 0]
    v2 = centers + offs[:, 1]
    verts = np.concatenate([v0, v1, v2]).astype(np.float32)
    n = n_tris
    t = np.stack(
        [np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], axis=1
    ).astype(np.int32)
    m = HostMaterial("grey")
    m.diffuse = (0.5, 0.5, 0.5)
    return MeshStorage(
        vertices=verts,
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.zeros(n, np.int32),
        materials=[m],
        group_names=["soup"],
        group_offsets=np.asarray([0, n], np.int32),
    )


def big_room(n_boxes: int = 2000, seed: int = 3) -> MeshStorage:
    """A bathroom2-class stress scene: a lit room filled with many boxes.

    Used for benchmarking at realistic triangle counts (~12 tris * n_boxes + walls)
    when reference .obj assets are unavailable.
    """
    base = cornell_box()
    base.transform(np.diag(np.array([8, 4, 8, 1], np.float32)))
    vs: List = []
    tris: List = []
    mats: List[int] = []
    r = np.random.default_rng(seed)
    for _ in range(n_boxes):
        c = (r.random(3) - 0.5) * np.array([14, 0, 14])
        c[1] = 0.0
        s = 0.1 + r.random(3) * np.array([0.5, 1.6, 0.5])
        _box(vs, tris, mats, c - [s[0], 0, s[2]], c + [s[0], s[1] * 2, s[2]], 0,
             rot_y=float(r.random() * 3.14))
    m = HostMaterial("clutter")
    m.diffuse = tuple(0.2 + 0.6 * r.random(3))
    t = np.asarray(tris, np.int32)
    clutter = MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.asarray(mats, np.int32),
        materials=[m],
        group_names=["clutter"],
        group_offsets=np.asarray([0, t.shape[0]], np.int32),
    )
    return base.merge(clutter)


def floor_quad(half: float = 1.0, albedo=(0.6, 0.6, 0.6),
               uv_indexed: bool = False) -> MeshStorage:
    """A single diffuse quad at y=0 spanning [-half, half]^2 (test subject
    for furnace / analytic-light parity checks)."""
    vs = [[-half, 0, half], [half, 0, half], [half, 0, -half],
          [-half, 0, -half]]
    tris = [[0, 1, 2], [0, 2, 3]]
    m = HostMaterial("floor")
    m.diffuse = tuple(albedo)
    t = np.asarray(tris, np.int32)
    return MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        material_ids=np.zeros(len(tris), np.int32),
        materials=[m],
        group_names=["floor"],
        group_offsets=np.asarray([0, t.shape[0]], np.int32),
    )


def bathroom_standin(n_boxes: int = 8300, seed: int = 3,
                     assets: str = "/root/reference/models/bathroom2"):
    """bathroom2 stand-in (BASELINE config #3 shape; VERDICT r2 #5).

    The reference's canonical demo is bathroom2 @ 1600x900 (README.md:46-48)
    but the checkout ships only its .fa/.mtl/textures — bathroom.obj is
    absent — so the geometry here is procedural (a lit room of ~n_boxes
    clutter boxes with per-face uv charts) while the MATERIALS ARE REAL:
    the bundled bathroom.mtl is parsed verbatim (Kd/Ks/Ns + map_Kd/map_Ks
    texture references) and the bundled .tga texture set is loaded through
    the standard atlas path. This exercises the full textured hot path
    (atlas fetch + ray-cone LOD + textured NEE) at reference triangle
    counts.

    Returns (MeshStorage, Camera, texture_dir).
    """
    import os

    from fermat_tpu.scene.loaders.obj import load_mtl

    mats = load_mtl(os.path.join(assets, "bathroom.mtl"))
    # ceiling light material appended last
    lm = HostMaterial("ceiling_light")
    lm.emissive = (14.0, 13.0, 12.0)
    materials = mats + [lm]
    n_mats = len(mats)

    vs: List = []
    tris: List = []
    midx: List[int] = []
    uvs: List = []
    r = np.random.default_rng(seed)

    # room shell: floor/ceiling/back/left/right, uv-mapped, tiled materials
    w, h, d = 8.0, 4.0, 8.0
    shell_mats = [r.integers(0, n_mats) for _ in range(5)]
    _quad(vs, tris, midx, [-w, 0, d], [w, 0, d], [w, 0, -d], [-w, 0, -d],
          int(shell_mats[0]), uvs=uvs)  # floor
    _quad(vs, tris, midx, [-w, 2 * h, -d], [w, 2 * h, -d], [w, 2 * h, d],
          [-w, 2 * h, d], int(shell_mats[1]), uvs=uvs)  # ceiling
    _quad(vs, tris, midx, [-w, 0, -d], [w, 0, -d], [w, 2 * h, -d],
          [-w, 2 * h, -d], int(shell_mats[2]), uvs=uvs)  # back
    _quad(vs, tris, midx, [-w, 0, d], [-w, 0, -d], [-w, 2 * h, -d],
          [-w, 2 * h, d], int(shell_mats[3]), uvs=uvs)  # left
    _quad(vs, tris, midx, [w, 0, -d], [w, 0, d], [w, 2 * h, d],
          [w, 2 * h, -d], int(shell_mats[4]), uvs=uvs)  # right
    # ceiling area light (emissive mesh, wound to face DOWN)
    _quad(vs, tris, midx, [-2.0, 2 * h - 0.01, 2.0], [-2.0, 2 * h - 0.01, -2.0],
          [2.0, 2 * h - 0.01, -2.0], [2.0, 2 * h - 0.01, 2.0],
          n_mats, uvs=uvs)

    for _ in range(n_boxes):
        c = (r.random(3) - 0.5) * np.array([14, 0, 14])
        c[1] = 0.0
        s = 0.1 + r.random(3) * np.array([0.5, 1.6, 0.5])
        _box(vs, tris, midx, c - [s[0], 0, s[2]], c + [s[0], s[1] * 2, s[2]],
             int(r.integers(0, n_mats)), rot_y=float(r.random() * 3.14),
             uvs=uvs)

    t = np.asarray(tris, np.int32)
    mesh = MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uvs=np.asarray(uvs, np.float32),
        uv_indices=t.copy(),  # uvs are vertex-parallel
        material_ids=np.asarray(midx, np.int32),
        materials=materials,
        group_names=["bathroom_standin"],
        group_offsets=np.asarray([0, t.shape[0]], np.int32),
    )
    cam = Camera.create(eye=(0.0, 4.5, 7.2), aim=(0.0, 2.0, -2.0), fov=60.0)
    # map_Kd names are relative to the .mtl's directory ("textures\\...")
    return mesh, cam, assets


def caustic_standin():
    """water_caustic stand-in (BASELINE config #4 shape; VERDICT r2 #5).

    water_caustic.obj is not bundled either; this builds the transport
    situation it exists for — a refractive slab over a diffuse floor with a
    small area light — which produces the SDS/caustic paths BPT is for.
    Returns (MeshStorage, Camera).
    """
    vs: List = []
    tris: List = []
    midx: List[int] = []

    floor = HostMaterial("floor")
    floor.diffuse = (0.75, 0.72, 0.65)
    glass = HostMaterial("glass")
    glass.diffuse = (0.0, 0.0, 0.0)
    glass.specular = (0.9, 0.9, 0.9)
    glass.ior = 1.33
    glass.opacity = 0.0  # pure refractor (glossy-trans lobe)
    glass.phong_exponent = 3000.0  # near-smooth water surface
    light = HostMaterial("light")
    light.emissive = (60.0, 58.0, 52.0)

    _quad(vs, tris, midx, [-3, 0, 3], [3, 0, 3], [3, 0, -3], [-3, 0, -3], 0)
    # water slab (top + bottom + sides matter little; top carries caustics)
    _box(vs, tris, midx, [-2.2, 0.8, -2.2], [2.2, 1.1, 2.2], 1)
    # small area light above the slab, wound to face DOWN
    _quad(vs, tris, midx, [-0.5, 3.2, 0.5], [-0.5, 3.2, -0.5],
          [0.5, 3.2, -0.5], [0.5, 3.2, 0.5], 2)

    t = np.asarray(tris, np.int32)
    mesh = MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.asarray(midx, np.int32),
        materials=[floor, glass, light],
        group_names=["caustic_standin"],
        group_offsets=np.asarray([0, t.shape[0]], np.int32),
    )
    cam = Camera.create(eye=(0.0, 2.6, 5.4), aim=(0.0, 0.6, 0.0), fov=45.0)
    return mesh, cam
