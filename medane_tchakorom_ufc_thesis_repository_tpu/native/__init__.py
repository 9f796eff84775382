"""Native (C++) assembly library with ctypes bindings.

Compiled on demand from ``src/assembly.cpp`` (g++ -O3 -fopenmp) into the
package directory; all entry points fall back to the numpy reference
implementations in ``core.poisson`` when no compiler is available, so the
framework never hard-depends on the native path.

This is the rebuild's native runtime component for host-side work — the
counterpart of the reference's C assembly layer (``poisson2DMatrix``,
``src/utils/utils.c:247-293``); device compute stays in XLA.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "assembly.cpp")
_SO = os.path.join(_HERE, "_assembly.so")

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compile the shared library; returns an error string on failure."""
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        "-o", _SO, _SRC,
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    return None


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None on failure."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(_SO)
        i64, f64 = ctypes.c_int64, ctypes.c_double
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.poisson2d_ell.argtypes = [i64, i64, f64, f64, p_i32, p_f64]
        lib.poisson3d_ell.argtypes = [i64, i64, i64, f64, f64, p_i32, p_f64]
        lib.poisson2d_dia.argtypes = [i64, i64, f64, f64, p_f64]
        lib.poisson3d_dia.argtypes = [i64, i64, i64, f64, f64, p_f64]
        lib.coo_to_ell.argtypes = [i64, i64, i64, p_i64, p_i64, p_f64,
                                   p_i32, p_f64]
        lib.coo_to_ell.restype = ctypes.c_int32
        lib.bsr_pack_plan.argtypes = [i64, i64, i64, i64, p_i64, p_i64,
                                      p_i64, p_i64, p_i32]
        lib.bsr_pack_plan.restype = i64
        lib.bsr_pack_fill.argtypes = [i64, i64, i64, i64, p_i64, p_i64,
                                      p_f64, p_i64, p_i64, p_i32,
                                      p_i32, p_f64]
        lib.bsr_pack_fill.restype = None
        _lib = lib
        return _lib


def bsr_pack(rows, cols, vals, shape, bs: int):
    """Native BSR (block-ELL) pack: ``(indices (nbr, width) int32,
    values (nbr, width, bs, bs) f64, blocks TRANSPOSED)`` — the OpenMP
    counterpart of ``core.operators._bsr_pack_np`` (counting-sort
    bucketing instead of the sort-based np.unique: measured 24 s -> ~1 s
    at 42M nnz).  Returns None when the native library is unavailable
    (caller falls back to numpy)."""
    lib = load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    nnz = rows.shape[0]
    nrows = int(shape[0])
    nbr = -(-nrows // bs)
    order = np.empty(max(nnz, 1), np.int64)
    rowptr = np.empty(nbr + 1, np.int64)
    slot = np.empty(max(nnz, 1), np.int32)
    width = lib.bsr_pack_plan(nnz, nrows, int(shape[1]), bs,
                              rows, cols, order, rowptr, slot)
    if width < 0:
        raise ValueError(
            f"bsr_pack: entry outside ({shape[0]}, {shape[1]})"
        )
    indices = np.empty((nbr, width), np.int32)
    values = np.empty((nbr, width, bs, bs), np.float64)
    lib.bsr_pack_fill(nnz, nrows, bs, width, rows, cols, vals,
                      order, rowptr, slot, indices, values)
    return indices, values


def available() -> bool:
    return load() is not None


def build_error() -> Optional[str]:
    load()
    return _build_error


# ---------------------------------------------------------------------------
# Native comm router (src/comm.cpp) — epoll TCP transport
# ---------------------------------------------------------------------------

_COMM_SRC = os.path.join(_HERE, "src", "comm.cpp")
_COMM_SO = os.path.join(_HERE, "_comm.so")

_comm_lib = None
_comm_error: Optional[str] = None


def _build_comm() -> Optional[str]:
    cmd = [
        "g++", "-O3", "-std=c++17", "-pthread", "-shared", "-fPIC",
        "-o", _COMM_SO, _COMM_SRC,
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    return None


def load_comm() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native comm router, or None."""
    global _comm_lib, _comm_error
    with _lib_lock:
        if _comm_lib is not None:
            return _comm_lib
        if _comm_error is not None:
            return None
        if not os.path.exists(_COMM_SO) or (
            os.path.exists(_COMM_SRC)
            and os.path.getmtime(_COMM_SRC) > os.path.getmtime(_COMM_SO)
        ):
            err = _build_comm()
            if err is not None:
                _comm_error = err
                return None
        lib = ctypes.CDLL(_COMM_SO)
        i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.comm_create.argtypes = [i32, ctypes.c_char_p]
        lib.comm_create.restype = i64
        lib.comm_send.argtypes = [i64, i32, i32, i32, i32, i32, u8p, i64]
        lib.comm_send.restype = i32
        lib.comm_drain.argtypes = [
            i64, np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            i32,
        ]
        lib.comm_drain.restype = i32
        lib.comm_read_data.argtypes = [
            i64, i32,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            i64, ctypes.POINTER(i32),
        ]
        lib.comm_read_data.restype = i64
        lib.comm_rtt.argtypes = [i64, i32, f64]
        lib.comm_rtt.restype = f64
        lib.comm_set_wan.argtypes = [i64, f64, f64, f64, f64, i64]
        lib.comm_set_wan.restype = i32
        lib.comm_close.argtypes = [i64]
        _comm_lib = lib
        return _comm_lib


def comm_available() -> bool:
    return load_comm() is not None


def comm_build_error() -> Optional[str]:
    load_comm()
    return _comm_error


# ---------------------------------------------------------------------------
# Clos routing library (src/clos.cpp) — Euler-split edge coloring for the
# AIJ gather SpMV (ops/clos_route.py)
# ---------------------------------------------------------------------------

_CLOS_SRC = os.path.join(_HERE, "src", "clos.cpp")
_CLOS_SO = os.path.join(_HERE, "_clos.so")

_clos_lib = None
_clos_error: Optional[str] = None


def _build_clos() -> Optional[str]:
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-o", _CLOS_SO, _CLOS_SRC,
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    return None


def load_clos() -> Optional[ctypes.CDLL]:
    global _clos_lib, _clos_error
    with _lib_lock:
        if _clos_lib is not None:
            return _clos_lib
        if _clos_error is not None:
            return None
        if not os.path.exists(_CLOS_SO) or (
            os.path.exists(_CLOS_SRC)
            and os.path.getmtime(_CLOS_SRC) > os.path.getmtime(_CLOS_SO)
        ):
            err = _build_clos()
            if err is not None:
                _clos_error = err
                return None
        lib = ctypes.CDLL(_CLOS_SO)
        i64 = ctypes.c_int64
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.euler_color.argtypes = [i64, i64, i64, i64, p_i64, p_i64, p_i32]
        lib.euler_color.restype = None
        lib.euler_color_blocks.argtypes = [i64, p_i64, p_i64, p_i32]
        lib.euler_color_blocks.restype = None
        lib.aij_pack_gblocks.argtypes = [i64, p_i64, p_i32, p_i32, p_i64,
                                         p_i64, p_i32, p_i64, p_i64]
        lib.aij_pack_gblocks.restype = i64
        _clos_lib = lib
        return _clos_lib


def clos_available() -> bool:
    return load_clos() is not None


def euler_color(src, dst, nl: int, nr: int, delta: int, out) -> None:
    """Native Δ-edge-coloring (see ops/clos_route.edge_color)."""
    lib = load_clos()
    assert lib is not None
    lib.euler_color(len(src), nl, nr, delta,
                    np.ascontiguousarray(src, np.int64),
                    np.ascontiguousarray(dst, np.int64), out)


def aij_pack_gblocks(chunk, s_all, l_all, order):
    """Native AIJ g-block greedy placement (``ops/aij_pack``'s
    pack-time hot loop); returns ``(chunk_ids, elem_order, src_off,
    block_of)`` or None when the library is unavailable."""
    lib = load_clos()
    if lib is None:
        return None
    m = len(order)
    chunk = np.ascontiguousarray(chunk, np.int64)
    s_all = np.ascontiguousarray(s_all, np.int32)
    l_all = np.ascontiguousarray(l_all, np.int32)
    order = np.ascontiguousarray(order, np.int64)
    elem_order = np.empty(max(m, 1), np.int64)
    src_off = np.empty(max(m, 1), np.int32)
    block_of = np.empty(max(m, 1), np.int64)
    chunk_of_block = np.empty(m + 1, np.int64)
    nb = lib.aij_pack_gblocks(m, chunk, s_all, l_all, order,
                              elem_order, src_off, block_of,
                              chunk_of_block)
    return (chunk_of_block[:nb].astype(np.int32), elem_order[:m],
            src_off[:m].astype(np.int64), block_of[:m])


def euler_color_blocks(src, dst) -> np.ndarray:
    """Batched per-block 8-colorings: ``src``/``dst`` are (nb, 1024)
    lane indices in [0, 128); returns (nb, 1024) int32 colors in [0, 8).
    Falls back to the python colorer block by block."""
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    nb = src.shape[0]
    out = np.zeros((nb, 1024), np.int32)
    lib = load_clos()
    if lib is not None:
        lib.euler_color_blocks(nb, src.reshape(-1), dst.reshape(-1),
                               out.reshape(-1))
        return out
    from medane_tchakorom_ufc_thesis_repository_tpu.ops import clos_route

    for b in range(nb):
        out[b] = clos_route.edge_color(src[b], dst[b], 128, 128, 8)
    return out


# ---------------------------------------------------------------------------
# numpy-facing builders (native fast path, numpy fallback)
# ---------------------------------------------------------------------------

def poisson2d_ell_np(m: int, n: int, diag: float = 4.0, off: float = -1.0):
    """ELL planes (indices int32 (m*n, 5), values f64) for 2D Poisson."""
    lib = load()
    size = m * n
    if lib is not None:
        indices = np.empty((size, 5), np.int32)
        values = np.empty((size, 5), np.float64)
        lib.poisson2d_ell(m, n, diag, off, indices, values)
        return indices, values
    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as pp

    ell = pp.coo_to_ell(*pp.poisson2d_coo(m, n, diag, off), width=5,
                        dtype=np.float64)
    return np.asarray(ell.indices), np.asarray(ell.values, np.float64)


def poisson3d_ell_np(nx: int, ny: int, nz: int, diag: float = 6.0,
                     off: float = -1.0):
    lib = load()
    size = nx * ny * nz
    if lib is not None:
        indices = np.empty((size, 7), np.int32)
        values = np.empty((size, 7), np.float64)
        lib.poisson3d_ell(nx, ny, nz, diag, off, indices, values)
        return indices, values
    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as pp

    ell = pp.coo_to_ell(*pp.poisson3d_coo(nx, ny, nz, diag, off), width=7,
                        dtype=np.float64)
    return np.asarray(ell.indices), np.asarray(ell.values, np.float64)


def poisson2d_dia_np(m: int, n: int, diag: float = 4.0, off: float = -1.0):
    """DIA planes (5, m*n) with offsets (-n, -1, 0, 1, n)."""
    lib = load()
    offsets = (-n, -1, 0, 1, n)
    if lib is not None:
        data = np.empty((5, m * n), np.float64)
        lib.poisson2d_dia(m, n, diag, off, data)
        return data, offsets
    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as pp

    dia = pp.poisson2d_dia(m, n, dtype=np.float64)
    return np.asarray(dia.data), dia.offsets


def poisson3d_dia_np(nx: int, ny: int, nz: int, diag: float = 6.0,
                     off: float = -1.0):
    lib = load()
    sx = ny * nz
    offsets = (-sx, -nz, -1, 0, 1, nz, sx)
    if lib is not None:
        data = np.empty((7, nx * ny * nz), np.float64)
        lib.poisson3d_dia(nx, ny, nz, diag, off, data)
        return data, offsets
    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as pp

    dia = pp.poisson3d_dia(nx, ny, nz, dtype=np.float64)
    return np.asarray(dia.data), dia.offsets


def coo_to_ell_np(rows, cols, vals, nrows: int, width: int):
    """General COO -> ELL packing (entries lexsorted by (row, col))."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    lib = load()
    if lib is not None:
        indices = np.empty((nrows, width), np.int32)
        values = np.empty((nrows, width), np.float64)
        rc = lib.coo_to_ell(len(rows), nrows, width, rows, cols, vals,
                            indices, values)
        if rc != 0:
            raise ValueError(f"a row exceeds ELL width {width}")
        return indices, values
    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as pp

    ell = pp.coo_to_ell(rows, cols, vals, (nrows, int(cols.max()) + 1),
                        width=width, dtype=np.float64)
    return np.asarray(ell.indices), np.asarray(ell.values, np.float64)
