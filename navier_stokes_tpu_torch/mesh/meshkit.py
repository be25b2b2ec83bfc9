"""ctypes bindings for the native meshkit library (``csrc/meshkit.cpp``).

Port of ``navier_stokes_tpu/mesh/meshkit.py``: fast gmsh parsing and
edge extraction in C++.  The library is built at first use with ``g++``
from the repository's ``csrc/meshkit.cpp`` into the git-ignored
``build/meshkit/`` (keyed by the source's hash; ``csrc/`` itself is left as
it is).  Where it cannot be built, ``available()`` is False and the numpy
implementations serve, as in the original.

Equivalence with the numpy path: edges are re-sorted lexicographically to
match ``np.unique`` ordering, so DoF numbering is bit-identical.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "csrc" / "meshkit.cpp"
_BUILD_DIR = _ROOT / "build" / "meshkit"
_CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-D_GNU_SOURCE", "-shared"]
_LIB = None
_TRIED = False


def _build() -> str | None:
    """Compile csrc/meshkit.cpp into build/meshkit/ unless a library built
    from the same source is there; the library path, or None on failure."""
    if not _SOURCE.exists():
        return None
    tag = hashlib.sha1(_SOURCE.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libmeshkit_{tag}.so"
    if lib.exists():
        return str(lib)
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True, timeout=120,
        )
        if r.returncode != 0:
            return None
        os.replace(tmp, lib)
        return str(lib)
    except (OSError, subprocess.SubprocessError):
        return None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.meshkit_parse.restype = ctypes.c_void_p
    lib.meshkit_parse.argtypes = [ctypes.c_char_p]
    lib.meshkit_error.restype = ctypes.c_char_p
    lib.meshkit_error.argtypes = [ctypes.c_void_p]
    for name in ("meshkit_dim",):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("meshkit_n_nodes", "meshkit_n_cells", "meshkit_n_bfacets"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.meshkit_coords.restype = ctypes.POINTER(ctypes.c_double)
    lib.meshkit_coords.argtypes = [ctypes.c_void_p]
    for name in ("meshkit_cells", "meshkit_cell_tags", "meshkit_bfacets", "meshkit_btags"):
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int32)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.meshkit_free.argtypes = [ctypes.c_void_p]
    lib.meshkit_edges.restype = ctypes.c_int64
    lib.meshkit_edges.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_msh_native(path: str, name: str | None = None):
    """Parse a .msh with the native library; returns a Mesh (or raises)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libmeshkit could not be built (g++ on csrc/meshkit.cpp)")
    h = lib.meshkit_parse(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        err = lib.meshkit_error(h)
        if err:
            raise ValueError(f"meshkit: {err.decode()}")
        dim = lib.meshkit_dim(h)
        nn = lib.meshkit_n_nodes(h)
        nc = lib.meshkit_n_cells(h)
        nb = lib.meshkit_n_bfacets(h)
        npc = 4 if dim == 3 else 3
        coords3 = np.ctypeslib.as_array(lib.meshkit_coords(h), shape=(nn, 3)).copy()
        cells = np.ctypeslib.as_array(lib.meshkit_cells(h), shape=(nc, npc)).copy()
        cell_tags = np.ctypeslib.as_array(lib.meshkit_cell_tags(h), shape=(nc,)).copy()
        bf = np.ctypeslib.as_array(lib.meshkit_bfacets(h), shape=(nb, npc - 1)).copy()
        bt = np.ctypeslib.as_array(lib.meshkit_btags(h), shape=(nb,)).copy()
    finally:
        lib.meshkit_free(h)

    if dim == 2:
        zspan = coords3[:, 2].max() - coords3[:, 2].min() if nn else 0.0
        if zspan > 1e-12 * max(1.0, np.abs(coords3).max()):
            raise NotImplementedError(f"{path}: surface mesh not supported")

    from .mesh import Mesh
    from .msh_io import _delete_unused_vertices

    coords, cells64, bf64 = _delete_unused_vertices(
        coords3[:, :dim], cells.astype(np.int64), bf.astype(np.int64)
    )
    return Mesh(
        coords=coords,
        cells=cells64.astype(np.int32),
        boundary_facets=bf64.astype(np.int32),
        boundary_tags=bt,
        name=name or path,
        cell_tags=cell_tags,
    )


def extract_edges_native(cells: np.ndarray, dim: int):
    """Native unique-edge extraction, reordered to match np.unique ordering."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libmeshkit could not be built")
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    nc, npc = cells.shape
    epc = 6 if npc == 4 else 3
    cap = nc * epc
    edges = np.empty((cap, 2), dtype=np.int32)
    cell_edges = np.empty((nc, epc), dtype=np.int32)
    n = lib.meshkit_edges(
        cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nc,
        npc,
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
        cell_edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n < 0:
        raise RuntimeError("meshkit_edges capacity exceeded")
    edges = edges[:n]
    # match numpy extract_edges (np.unique lexicographic order)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    inv = np.empty(n, dtype=np.int32)
    inv[order] = np.arange(n, dtype=np.int32)
    return edges[order].copy(), inv[cell_edges]
