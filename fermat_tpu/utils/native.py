"""ctypes bindings for the native runtime (native/fermat_native.cpp).

The compute path is JAX/XLA/Pallas; this is the C++ host runtime for
CPU-bound systems work — scene ingestion and BVH construction — mirroring
the reference's host C++ (src/mesh/MeshBase.cpp, cugar bvh_sah_builder.h).

The library is built from native/fermat_native.cpp with g++ into
native/build/ (listed in .gitignore) at first use, and again whenever the
source is newer than the library; every entry point degrades to the
pure-python implementation when no compiler is available.
"""
from __future__ import annotations

import ctypes as C
import os
import subprocess
import sys
from typing import Optional

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_DIR, "fermat_native.cpp")
_SO = os.path.join(_DIR, "build", "libfermat_native.so")
_lib = None
_tried = False


class _ObjResult(C.Structure):
    _fields_ = [
        ("vertices", C.POINTER(C.c_float)),
        ("normals", C.POINTER(C.c_float)),
        ("uvs", C.POINTER(C.c_float)),
        ("tri_v", C.POINTER(C.c_int32)),
        ("tri_n", C.POINTER(C.c_int32)),
        ("tri_uv", C.POINTER(C.c_int32)),
        ("tri_mat", C.POINTER(C.c_int32)),
        ("mat_names", C.c_char_p),
        ("nv", C.c_int64), ("nn", C.c_int64), ("nt", C.c_int64),
        ("ntri", C.c_int64), ("n_mats", C.c_int64), ("mat_names_len", C.c_int64),
    ]


class _BvhResult(C.Structure):
    _fields_ = [
        ("lo", C.POINTER(C.c_float)),
        ("hi", C.POINTER(C.c_float)),
        ("skip", C.POINTER(C.c_int32)),
        ("prim_start", C.POINTER(C.c_int32)),
        ("is_leaf", C.POINTER(C.c_uint8)),
        ("prims", C.POINTER(C.c_int32)),
        ("n_nodes", C.c_int64),
        ("n_prim_slots", C.c_int64),
    ]


def _load() -> Optional[C.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SRC):
        return None
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        # build under a private name, then rename: concurrent processes
        # (test workers) never load a half-written library
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=300,
            )
            os.replace(tmp, _SO)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"[native] build failed: {e}", file=sys.stderr)
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    try:
        lib = C.CDLL(_SO)
    except OSError as e:
        print(f"[native] load failed: {e}", file=sys.stderr)
        return None
    lib.obj_load.restype = C.POINTER(_ObjResult)
    lib.obj_load.argtypes = [C.c_char_p]
    lib.obj_free.argtypes = [C.POINTER(_ObjResult)]
    lib.bvh_build.restype = C.POINTER(_BvhResult)
    lib.bvh_build.argtypes = [
        C.POINTER(C.c_float), C.POINTER(C.c_float), C.POINTER(C.c_float),
        C.c_int64, C.c_int32,
    ]
    lib.bvh_free.argtypes = [C.POINTER(_BvhResult)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_np(ptr, shape, dtype):
    n = int(np.prod(shape))
    if n == 0:
        return np.zeros(shape, dtype)
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)
    return arr.reshape(shape)


def load_obj_geometry(path: str):
    """Native OBJ parse -> dict of numpy arrays, or None if unavailable.

    Returns vertices/normals/uvs/tri_v/tri_n/tri_uv/tri_mat/material_names.
    """
    lib = _load()
    if lib is None:
        return None
    rp = lib.obj_load(path.encode())
    if not rp:
        return None
    r = rp.contents
    out = {
        "vertices": _as_np(r.vertices, (int(r.nv), 3), np.float32),
        "normals": _as_np(r.normals, (int(r.nn), 3), np.float32),
        "uvs": _as_np(r.uvs, (int(r.nt), 2), np.float32),
        "tri_v": _as_np(r.tri_v, (int(r.ntri), 3), np.int32),
        "tri_n": _as_np(r.tri_n, (int(r.ntri), 3), np.int32),
        "tri_uv": _as_np(r.tri_uv, (int(r.ntri), 3), np.int32),
        "tri_mat": _as_np(r.tri_mat, (int(r.ntri),), np.int32),
        "material_names": (
            C.string_at(r.mat_names, int(r.mat_names_len)).decode().split("\n")[:-1]
            if r.mat_names_len
            else []
        ),
    }
    lib.obj_free(rp)
    return out


def build_bvh_native(centroids: np.ndarray, lo: np.ndarray, hi: np.ndarray, leaf_size: int = 4):
    """Native binned-SAH build -> flattened skip-link arrays, or None."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, np.float32)
    l = np.ascontiguousarray(lo, np.float32)
    h = np.ascontiguousarray(hi, np.float32)
    n = c.shape[0]
    fp = C.POINTER(C.c_float)
    rp = lib.bvh_build(
        c.ctypes.data_as(fp), l.ctypes.data_as(fp), h.ctypes.data_as(fp),
        C.c_int64(n), C.c_int32(leaf_size),
    )
    if not rp:
        return None
    r = rp.contents
    nn = int(r.n_nodes)
    out = {
        "lo": _as_np(r.lo, (nn, 3), np.float32),
        "hi": _as_np(r.hi, (nn, 3), np.float32),
        "skip": _as_np(r.skip, (nn,), np.int32),
        "prim_start": _as_np(r.prim_start, (nn,), np.int32),
        "is_leaf": _as_np(r.is_leaf, (nn,), np.uint8).astype(bool),
        "prims": _as_np(r.prims, (int(r.n_prim_slots),), np.int32),
    }
    lib.bvh_free(rp)
    return out
