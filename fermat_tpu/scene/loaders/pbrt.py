"""PBRT scene importer.

Reference: src/pbrt_importer.cpp + src/pbrt_parser.cpp (+ film handling at
renderer.cu:704-720). Directive coverage:
  Transform / ConcatTransform / Identity / LookAt / Translate / Rotate /
    Scale (column-major CTM, right-composed like pbrt's pbrtTransform API)
  TransformBegin/End and AttributeBegin/End (full graphics-state stack:
    CTM + current material + area-light emission)
  Include (token splice)
  Camera "perspective" fov  (CTM at Camera = world-to-camera)
  Film xresolution/yresolution
  Texture "imagemap" (file-backed), "checkerboard" (baked to a TGA so the
    real texture pipeline samples it), "constant"
  MakeNamedMaterial / NamedMaterial / anonymous Material
    (matte / metal / substrate / glass / mirror / uber / plastic)
  AreaLightSource "diffuse" -> emissive override on subsequent shapes
  Shape "trianglemesh" (inline P/N/uv/indices), "plymesh", "sphere",
    "disk" (analytic shapes tessellated — the renderer is mesh-only by
    design, every surface rides the same tracer)
  ObjectBegin/ObjectEnd/ObjectInstance (mesh instancing by merge —
    flattened at load; the tracer's input is one global mesh)
  LightSource "infinite" -> constant env radiance from "L", or a full
    textured infinite light when "mapname" resolves to a file (loaded into
    scene.envmap.EnvMapView: radiance on miss + importance-sampled NEE —
    the reference stubs env lighting out entirely, pathtracer_core.h:1251)
  LightSource "distant" -> directional light; "point" -> delta point light
"""
from __future__ import annotations

import copy
import math
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from fermat_tpu.core.camera import Camera
from fermat_tpu.scene.materials import HostMaterial
from fermat_tpu.scene.mesh import MeshStorage


@dataclass
class PbrtScene:
    mesh: MeshStorage
    camera: Optional[Camera]
    resolution: Tuple[int, int] = (512, 512)
    env_radiance: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    env_map: "object" = None  # (H, W, 3) float32 lat-long radiance or None
    dir_lights: tuple = ()  # DirectionalLightDef list (fa.py dataclass)
    point_lights: tuple = ()  # ((px,py,pz), (ix,iy,iz)) pairs
    # film options copied out exactly like renderer.cu:716-717
    exposure: float = 1.0
    gamma: float = 2.2


def _tokenize(text: str) -> List[str]:
    text = re.sub(r"#.*", "", text)
    return re.findall(r'"[^"]*"|\[|\]|[^\s\[\]]+', text)


def _conductor_f0(eta, k):
    """Normal-incidence reflectance of a conductor (pbrt metal -> F0)."""
    num = (eta - 1.0) ** 2 + k**2
    den = (eta + 1.0) ** 2 + k**2
    return num / np.maximum(den, 1e-9)


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _scale(x, y, z):
    return np.diag([x, y, z, 1.0])


def _rotate(deg, x, y, z):
    a = np.array([x, y, z], np.float64)
    n = np.linalg.norm(a)
    if n == 0:
        return np.eye(4)
    a /= n
    s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) * c + (1 - c) * np.outer(a, a) + s * K
    return m


def _lookat_w2c(eye, look, up):
    """pbrt LookAt: the CTM gets the WORLD-TO-CAMERA transform appended
    (camera space: +z forward, +y up)."""
    eye, look, up = (np.asarray(v, np.float64) for v in (eye, look, up))
    d = look - eye
    d /= np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    newup = np.cross(d, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, newup, d, eye
    return np.linalg.inv(c2w)


def _sphere_mesh(radius: float, n_u: int = 32, n_v: int = 16) -> MeshStorage:
    """Lat-long tessellated sphere in object space (Z axis = pbrt pole)."""
    vs, uvs, tris = [], [], []
    for j in range(n_v + 1):
        th = math.pi * j / n_v
        for i in range(n_u + 1):
            ph = 2 * math.pi * i / n_u
            vs.append([
                radius * math.sin(th) * math.cos(ph),
                radius * math.sin(th) * math.sin(ph),
                radius * math.cos(th),
            ])
            uvs.append([i / n_u, j / n_v])
    row = n_u + 1
    for j in range(n_v):
        for i in range(n_u):
            a, b = j * row + i, j * row + i + 1
            c, d = (j + 1) * row + i, (j + 1) * row + i + 1
            if j > 0:
                tris.append([a, b, c])
            if j < n_v - 1:
                tris.append([b, d, c])
    t = np.asarray(tris, np.int32)
    return MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uvs=np.asarray(uvs, np.float32),
        uv_indices=t.copy(),
        material_ids=np.zeros(t.shape[0], np.int32),
        group_names=["sphere"],
        group_offsets=np.asarray([0, t.shape[0]], np.int32),
    )


def _disk_mesh(radius: float, height: float, inner: float,
               n: int = 32) -> MeshStorage:
    vs, tris = [], []
    if inner <= 0.0:
        vs.append([0.0, 0.0, height])
        for i in range(n):
            ph = 2 * math.pi * i / n
            vs.append([radius * math.cos(ph), radius * math.sin(ph), height])
        for i in range(n):
            tris.append([0, 1 + i, 1 + (i + 1) % n])
    else:
        for i in range(n):
            ph = 2 * math.pi * i / n
            vs.append([inner * math.cos(ph), inner * math.sin(ph), height])
            vs.append([radius * math.cos(ph), radius * math.sin(ph), height])
        for i in range(n):
            a, b = 2 * i, 2 * i + 1
            c, d = 2 * ((i + 1) % n), 2 * ((i + 1) % n) + 1
            tris += [[a, b, d], [a, d, c]]
    t = np.asarray(tris, np.int32)
    return MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        material_ids=np.zeros(t.shape[0], np.int32),
        group_names=["disk"],
        group_offsets=np.asarray([0, t.shape[0]], np.int32),
    )


class _Parser:
    def __init__(self, path: str):
        self.base = os.path.dirname(os.path.abspath(path))
        self.toks = _tokenize(open(path, "r", errors="replace").read())
        self.i = 0
        self.ctm = np.eye(4, dtype=np.float64)
        self.tstack: List[np.ndarray] = []  # TransformBegin
        self.astack: List[tuple] = []  # AttributeBegin: (ctm, mat, arealight)
        self.world_to_camera = None
        self.camera_fov = 60.0
        self.resolution = (512, 512)
        self.exposure = 1.0
        self.gamma = 2.2
        self.materials: Dict[str, HostMaterial] = {}
        self.cur_mat: Optional[str] = None
        self.area_light: Optional[tuple] = None  # pending emissive override
        # texture registry: name -> {"mean": rgb, "file": abspath or None}
        self.textures: Dict[str, dict] = {}
        self._bake_dir: Optional[str] = None
        self._anon = 0
        self.mesh = MeshStorage()
        self.env = (0.0, 0.0, 0.0)
        self.env_img = None
        self.dir_lights: List = []
        self.point_lights: List = []
        # ObjectBegin state: name -> list of (mesh, ctm_at_shape); the
        # inverse of the CTM at ObjectBegin re-bases shapes to object space
        self.objects: Dict[str, list] = {}
        self.cur_object: Optional[str] = None
        self.obj_base_inv: Optional[np.ndarray] = None

    def _next(self) -> str:
        t = self.toks[self.i]
        self.i += 1
        return t

    def _peek(self) -> str:
        return self.toks[self.i] if self.i < len(self.toks) else ""

    def _floats(self, k: int) -> List[float]:
        vals = []
        if self._peek() == "[":
            self._next()
            while self._peek() != "]":
                vals.append(float(self._next()))
            self._next()
        else:
            vals = [float(self._next()) for _ in range(k)]
        return vals

    def _read_params(self) -> Dict[str, list]:
        """Read "type name" [ values ] pairs until the next directive."""
        params = {}
        while self.i < len(self.toks) and self._peek().startswith('"'):
            decl = self._next().strip('"')
            parts = decl.split()
            name = parts[-1]
            vals = []
            if self._peek() == "[":
                self._next()
                while self._peek() != "]":
                    vals.append(self._next().strip('"'))
                self._next()
            elif self.i < len(self.toks):
                vals.append(self._next().strip('"'))
            def conv(v):
                try:
                    return float(v)
                except ValueError:
                    return v
            params[name] = [conv(v) for v in vals]
        return params

    # ---- graphics state ----------------------------------------------------

    def _push_attrs(self):
        self.astack.append((self.ctm.copy(), self.cur_mat, self.area_light))

    def _pop_attrs(self):
        if self.astack:
            self.ctm, self.cur_mat, self.area_light = self.astack.pop()

    # ---- main loop ---------------------------------------------------------

    def parse(self) -> PbrtScene:
        while self.i < len(self.toks):
            tok = self._next()
            if tok == "Transform":
                vals = self._floats(16)
                # pbrt matrices are column-major
                self.ctm = np.array(vals, np.float64).reshape(4, 4).T
            elif tok == "ConcatTransform":
                vals = self._floats(16)
                self.ctm = self.ctm @ np.array(vals, np.float64).reshape(4, 4).T
            elif tok == "Identity":
                self.ctm = np.eye(4)
            elif tok == "LookAt":
                v = self._floats(9)
                self.ctm = self.ctm @ _lookat_w2c(v[0:3], v[3:6], v[6:9])
            elif tok == "Translate":
                v = self._floats(3)
                self.ctm = self.ctm @ _translate(*v)
            elif tok == "Scale":
                v = self._floats(3)
                self.ctm = self.ctm @ _scale(*v)
            elif tok == "Rotate":
                v = self._floats(4)
                self.ctm = self.ctm @ _rotate(*v)
            elif tok == "TransformBegin":
                self.tstack.append(self.ctm.copy())
            elif tok == "TransformEnd":
                if self.tstack:
                    self.ctm = self.tstack.pop()
            elif tok == "AttributeBegin":
                self._push_attrs()
            elif tok == "AttributeEnd":
                self._pop_attrs()
            elif tok == "Include":
                fn = os.path.join(self.base, self._next().strip('"'))
                if os.path.exists(fn):
                    inc = _tokenize(open(fn, "r", errors="replace").read())
                    self.toks[self.i:self.i] = inc
            elif tok == "Camera":
                self._next().strip('"')
                params = self._read_params()
                if "fov" in params:
                    self.camera_fov = float(params["fov"][0])
                self.world_to_camera = self.ctm.copy()
            elif tok == "Film":
                self._next()
                params = self._read_params()
                rx = int(params.get("xresolution", [512])[0])
                ry = int(params.get("yresolution", [512])[0])
                self.resolution = (rx, ry)
                self.exposure = float(params.get("exposure", [self.exposure])[0])
                self.gamma = float(params.get("gamma", [self.gamma])[0])
            elif tok == "WorldBegin":
                self.ctm = np.eye(4)
                self.tstack, self.astack = [], []
            elif tok == "Texture":
                self._texture()
            elif tok == "MakeNamedMaterial":
                name = self._next().strip('"')
                params = self._read_params()
                self.materials[name] = self._material(name, params)
            elif tok == "NamedMaterial":
                self.cur_mat = self._next().strip('"')
            elif tok == "Material":
                kind = self._next().strip('"')
                params = self._read_params()
                if kind:
                    params.setdefault("type", [kind])
                    self._anon += 1
                    name = f"__anon{self._anon}"
                    self.materials[name] = self._material(name, params)
                    self.cur_mat = name
                else:
                    self.cur_mat = None  # Material "": no material
            elif tok == "AreaLightSource":
                kind = self._next().strip('"')
                params = self._read_params()
                L = params.get("L", [1.0, 1.0, 1.0])[:3]
                sc = params.get("scale", [1.0])
                s = float(sc[0]) if sc and isinstance(sc[0], float) else 1.0
                if kind == "diffuse":
                    self.area_light = tuple(float(x) * s for x in L)
            elif tok == "LightSource":
                self._light_source()
            elif tok == "Shape":
                kind = self._next().strip('"')
                params = self._read_params()
                self._shape(kind, params)
            elif tok == "ObjectBegin":
                self.cur_object = self._next().strip('"')
                self.objects.setdefault(self.cur_object, [])
                self.obj_base_inv = np.linalg.inv(self.ctm)
                self._push_attrs()
            elif tok == "ObjectEnd":
                self.cur_object = None
                self.obj_base_inv = None
                self._pop_attrs()
            elif tok == "ObjectInstance":
                name = self._next().strip('"')
                for sub, m_rel in self.objects.get(name, []):
                    inst = copy.deepcopy(sub)
                    inst.transform((self.ctm @ m_rel).astype(np.float32))
                    self.mesh.merge(inst)
            elif tok in ("Integrator", "Sampler", "PixelFilter", "Accelerator",
                         "Option", "ColorSpace", "MakeNamedMedium"):
                self._next()
                self._read_params()
            elif tok in ("WorldEnd", "ReverseOrientation", "ObjectInstanceEnd",
                         "MediumInterface", "AttributeIgnore"):
                pass
            # unknown directives: skip (their params are consumed lazily)
        return self._finish()

    # ---- directives --------------------------------------------------------

    def _texture(self):
        name = self._next().strip('"')
        self._next()  # value type (spectrum/float)
        klass = self._next().strip('"')
        params = self._read_params()
        entry = {"mean": (0.5, 0.5, 0.5), "file": None}
        if klass == "imagemap":
            fn = str(params.get("filename", [""])[0])
            fp = os.path.join(self.base, fn)
            if fn and os.path.exists(fp):
                entry["file"] = os.path.abspath(fp)
        elif klass == "checkerboard":
            t1 = [float(x) for x in params.get("tex1", [0.3, 0.3, 0.3])[:3]]
            t2 = [float(x) for x in params.get("tex2", [0.7, 0.7, 0.7])[:3]]
            us = float(params.get("uscale", [1.0])[0])
            vs = float(params.get("vscale", [1.0])[0])
            entry["mean"] = tuple((a + b) / 2.0 for a, b in zip(t1, t2))
            entry["file"] = self._bake_checker(name, t1, t2, us, vs)
        elif klass == "constant":
            v = params.get("value", [0.5])
            v = [float(x) for x in v[:3]] if len(v) >= 3 else [float(v[0])] * 3
            entry["mean"] = tuple(v)
        self.textures[name] = entry

    def _bake_checker(self, name, t1, t2, us, vs) -> str:
        """Bake a checkerboard into a real TGA so the texture pipeline
        (mip chains + ray-cone LOD) samples it instead of a mean color."""
        from fermat_tpu.utils.image import write_tga

        res = 256
        u = (np.arange(res) + 0.5) / res
        par = (np.add.outer(np.floor(u * vs), np.floor(u * us))
               % 2.0)[..., None]
        img = np.where(par < 1.0, np.asarray(t1, np.float32),
                       np.asarray(t2, np.float32)).astype(np.float32)
        if self._bake_dir is None:
            self._bake_dir = tempfile.mkdtemp(prefix="pbrt_tex_")
        fp = os.path.join(self._bake_dir, f"{re.sub('[^A-Za-z0-9_]', '_', name)}.tga")
        write_tga(fp, np.clip(img, 0.0, 1.0))
        return fp

    def _light_source(self):
        kind = self._next().strip('"')
        params = self._read_params()
        sc = params.get("scale", [1.0])
        s = float(sc[0]) if sc and isinstance(sc[0], float) else 1.0
        if kind == "infinite":
            if "L" in params and isinstance(params["L"][0], float):
                self.env = tuple(float(x) * s for x in params["L"][:3])
            else:
                mapname = params.get("mapname", params.get("filename", [""]))[0]
                fp = os.path.join(self.base, str(mapname))
                if mapname and os.path.exists(fp):
                    from fermat_tpu.utils.image import read_image

                    # full textured infinite light: the lat-long map feeds
                    # scene.envmap.EnvMapView (radiance on miss +
                    # importance-sampled NEE)
                    self.env_img = read_image(fp)[..., :3]
                self.env = (s, s, s)
        elif kind == "distant":
            from fermat_tpu.scene.loaders.fa import DirectionalLightDef

            fr = [float(x) for x in params.get("from", [0, 0, 0])[:3]]
            to = [float(x) for x in params.get("to", [0, 0, 1])[:3]]
            L = [float(x) * s for x in params.get("L", [1, 1, 1])[:3]]
            d = np.asarray(to) - np.asarray(fr)
            d = (self.ctm[:3, :3] @ d)
            self.dir_lights.append(DirectionalLightDef(tuple(d), tuple(L)))
        elif kind == "point":
            fr = [float(x) for x in params.get("from", [0, 0, 0])[:3]] + [1.0]
            I = [float(x) * s for x in params.get("I", [1, 1, 1])[:3]]
            p = (self.ctm @ np.asarray(fr))[:3]
            self.point_lights.append((tuple(p), tuple(I)))

    def _material(self, name: str, p: Dict[str, list]) -> HostMaterial:
        m = HostMaterial(name)
        kind = str(p.get("type", ["matte"])[0])
        rough = float(p.get("uroughness", p.get("roughness", [0.1]))[0])
        # our roughness == alpha-ish linear roughness; pbrt rough is alpha
        m.phong_exponent = 1.0 / max(rough, 1e-4)  # inverse of our 1/Ns map

        def diffuse_of(key, default):
            """Color param that may be a texture reference."""
            kd = p.get(key, list(default))
            if isinstance(kd[0], str):
                tex = self.textures.get(kd[0], {"mean": default, "file": None})
                if tex["file"]:
                    m.diffuse_map_name = tex["file"]
                    return (1.0, 1.0, 1.0)  # modulated by the map
                return tuple(tex["mean"])
            return tuple(float(x) for x in kd[:3])

        if kind in ("matte", "plastic", "uber"):
            m.diffuse = diffuse_of("Kd", (0.5, 0.5, 0.5))
            if kind in ("plastic", "uber"):
                ks = p.get("Ks", [0.25] * 3 if kind == "plastic" else [0.0] * 3)
                if not isinstance(ks[0], str):
                    m.specular = tuple(float(x) * math.pi for x in ks[:3])
        elif kind == "metal":
            eta = np.array(p.get("eta", [0.2, 0.92, 1.1])[:3])
            k = np.array(p.get("k", [3.9, 2.45, 2.14])[:3])
            f0 = _conductor_f0(eta, k)
            m.specular = tuple(float(x) * math.pi for x in f0)  # F0 = spec/pi
            m.diffuse = (0.0, 0.0, 0.0)
        elif kind == "mirror":
            kr = p.get("Kr", [0.9, 0.9, 0.9])
            m.diffuse = (0.0, 0.0, 0.0)
            m.reflectivity = tuple(float(x) for x in kr[:3])
            m.phong_exponent = 1.0e4  # near-delta glossy lobe
            m.specular = tuple(float(x) * math.pi for x in kr[:3])
        elif kind == "substrate":
            m.diffuse = diffuse_of("Kd", (0.5, 0.5, 0.5))
            ks = p.get("Ks", [0.04, 0.04, 0.04])
            m.specular = tuple(float(x) * math.pi for x in ks[:3])
        elif kind == "glass":
            m.diffuse = (0.0, 0.0, 0.0)
            m.opacity = 0.0
            m.ior = float(p.get("index", p.get("eta", [1.5]))[0])
            m.specular = (0.04 * math.pi,) * 3
        return m

    def _shape(self, kind: str, p: Dict[str, list]):
        sub = None
        if kind == "trianglemesh":
            P = np.array(p.get("P", []), np.float32).reshape(-1, 3)
            N = np.array(p.get("N", []), np.float32).reshape(-1, 3)
            UV = np.array(p.get("uv", p.get("st", [])), np.float32).reshape(-1, 2)
            idx = np.array(p.get("indices", []), np.int32).reshape(-1, 3)
            sub = MeshStorage(
                vertices=P,
                triangles=idx,
                normals=N,
                normal_indices=idx.copy() if N.shape[0] else np.full_like(idx, -1),
                uvs=UV,
                uv_indices=idx.copy() if UV.shape[0] else np.full_like(idx, -1),
                material_ids=np.zeros(idx.shape[0], np.int32),
                group_names=["trianglemesh"],
                group_offsets=np.asarray([0, idx.shape[0]], np.int32),
            )
        elif kind == "plymesh":
            from fermat_tpu.scene.loaders.ply import load_ply

            fn = os.path.join(self.base, str(p.get("filename", [""])[0]))
            if os.path.exists(fn):
                sub = load_ply(fn)
        elif kind == "sphere":
            sub = _sphere_mesh(float(p.get("radius", [1.0])[0]))
        elif kind == "disk":
            sub = _disk_mesh(
                float(p.get("radius", [1.0])[0]),
                float(p.get("height", [0.0])[0]),
                float(p.get("innerradius", [0.0])[0]),
            )
        if sub is None or not sub.n_triangles:
            return
        sub.materials = [self._shape_material()]
        if self.cur_object is not None:
            # record in object space (re-based by inv CTM-at-ObjectBegin)
            self.objects[self.cur_object].append(
                (sub, self.obj_base_inv @ self.ctm))
        else:
            sub.transform(self.ctm.astype(np.float32))
            self.mesh.merge(sub)

    def _shape_material(self) -> HostMaterial:
        base = self.materials.get(self.cur_mat or "", None)
        if self.area_light is None:
            return base if base is not None else HostMaterial("default")
        # AreaLightSource: emissive override on a copy (pbrt semantics:
        # the light attaches to the shape, not the named material)
        m = copy.deepcopy(base) if base is not None else HostMaterial("arealight")
        m.name = (m.name or "mat") + "_arealight"
        m.emissive = self.area_light
        return m

    def _finish(self) -> PbrtScene:
        cam = None
        if self.world_to_camera is not None:
            c2w = np.linalg.inv(self.world_to_camera)
            eye = c2w[:3, 3]
            # pbrt camera space: +z forward, +y up
            fwd = c2w[:3, :3] @ np.array([0, 0, 1.0])
            up = c2w[:3, :3] @ np.array([0, 1.0, 0])
            cam = Camera.create(
                tuple(eye), tuple(eye + fwd), tuple(up),
                math.radians(self.camera_fov),
            )
        return PbrtScene(
            mesh=self.mesh,
            camera=cam,
            resolution=self.resolution,
            exposure=self.exposure,
            gamma=self.gamma,
            env_radiance=self.env,
            env_map=self.env_img,
            dir_lights=tuple(self.dir_lights),
            point_lights=tuple(self.point_lights),
        )


def load_pbrt(path: str) -> PbrtScene:
    return _Parser(path).parse()
