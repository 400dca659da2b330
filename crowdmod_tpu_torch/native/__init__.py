"""The port's native (C++) host runtime, through ctypes (port of the JAX
package's ``native``).

The host-side data path around the card is C++ (``src/crowdmod_native.cpp``,
built by :mod:`.build`): a threaded layout transpose, a window-batch
gather, trajectory → macroprop binning, and the ``.cmb`` binary tensor
files, byte for byte the JAX package's format.  Unlike the JAX package,
the public functions do not fall back to numpy: when the library cannot
be built they raise with the compiler's message.  Each has a numpy twin,
``<name>_reference``, the oracle of the tests.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from crowdmod_tpu_torch.native.build import build_library

_lock = threading.Lock()
_loaded: list[ctypes.CDLL] = []


def _lib() -> ctypes.CDLL:
    """The loaded library, built at first use; raises if it cannot be."""
    with _lock:
        if _loaded:
            return _loaded[0]
        lib = ctypes.CDLL(str(build_library()))
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i64 = ctypes.c_int64
        lib.cm_transpose_nchwl_to_nlhwc.argtypes = [f32p, f32p] + [i64] * 5
        lib.cm_gather_windows.argtypes = [f32p] + [i64] * 5 + [i64p, i64p, i64, i64, f32p]
        lib.cm_bin_frames.argtypes = ([f64p] * 5 + [i64p, i64, i64, i64]
                                      + [ctypes.c_double] * 5 + [f32p])
        lib.cm_write_tensor.argtypes = [ctypes.c_char_p, f32p, i64p, ctypes.c_int32]
        lib.cm_write_tensor.restype = ctypes.c_int
        lib.cm_tensor_ndim.argtypes = [ctypes.c_char_p, i64p]
        lib.cm_tensor_ndim.restype = ctypes.c_int
        lib.cm_read_tensor.argtypes = [ctypes.c_char_p, f32p, i64]
        lib.cm_read_tensor.restype = ctypes.c_int
        _loaded.append(lib)
        return lib


def native_available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


# ---------------------------------------------------------------------------
# Layout transpose
# ---------------------------------------------------------------------------

def transpose_to_native(arr: np.ndarray) -> np.ndarray:
    """Reference pickle layout ``(N, C, H, W, L)`` → the port's ``(N, L, H,
    W, C)``, threaded over N."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    n, c, h, w, l = arr.shape
    out = np.empty((n, l, h, w, c), dtype=np.float32)
    _lib().cm_transpose_nchwl_to_nlhwc(_f32(arr), _f32(out), n, c, h, w, l)
    return out


def transpose_to_native_reference(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(arr, np.float32), (0, 4, 2, 3, 1)))


# ---------------------------------------------------------------------------
# Window gather
# ---------------------------------------------------------------------------

def _window_args(raw, seq_idx, t0, window):
    raw = np.ascontiguousarray(raw, dtype=np.float32)
    seq_idx = np.ascontiguousarray(seq_idx, dtype=np.int64)
    t0 = np.ascontiguousarray(t0, dtype=np.int64)
    n, l = raw.shape[:2]
    if seq_idx.shape != t0.shape or ((seq_idx < 0) | (seq_idx >= n)).any() or (
            (t0 < 0) | (t0 + window > l)).any():
        raise ValueError(f"windows outside a ({n}, {l}, ...) array: seq {seq_idx}, t0 {t0}, "
                         f"window {window}")
    return raw, seq_idx, t0


def gather_windows(raw: np.ndarray, seq_idx: np.ndarray, t0: np.ndarray,
                   window: int) -> np.ndarray:
    """Pack windows ``raw[seq[i], t0[i]:t0[i]+window]`` → ``(B, window, H,
    W, C)``, one threaded memcpy a window."""
    raw, seq_idx, t0 = _window_args(raw, seq_idx, t0, window)
    n, l, h, w, c = raw.shape
    out = np.empty((len(seq_idx), window, h, w, c), dtype=np.float32)
    _lib().cm_gather_windows(_f32(raw), n, l, h, w, c, _i64(seq_idx), _i64(t0),
                             len(seq_idx), window, _f32(out))
    return out


def gather_windows_reference(raw, seq_idx, t0, window: int) -> np.ndarray:
    raw, seq_idx, t0 = _window_args(raw, seq_idx, t0, window)
    return raw[seq_idx[:, None], t0[:, None] + np.arange(window)[None, :]]


# ---------------------------------------------------------------------------
# Trajectory binning
# ---------------------------------------------------------------------------

def _bin_args(x, y, vx, vy, vnorm, offsets):
    cols = [np.ascontiguousarray(a, dtype=np.float64) for a in (x, y, vx, vy, vnorm)]
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(cols[0])
    if (any(len(a) != n for a in cols) or len(offsets) < 1 or offsets[0] < 0
            or offsets[-1] > n or (np.diff(offsets) < 0).any()):
        raise ValueError(f"offsets {offsets} do not split {n} rows of equal columns")
    return (*cols, offsets)


def bin_frames(x, y, vx, vy, vnorm, offsets, *, rows: int, cols: int, dx: float,
               dy: float, lu, eps: float = 1e-6) -> np.ndarray:
    """Bin per-frame pedestrian lists → ``(F, rows, cols, 4)`` macroprops in
    float64 sums, threaded over frames.  ``offsets`` has length F+1: frame
    f owns rows [offsets[f], offsets[f+1]) of the flat arrays."""
    x, y, vx, vy, vnorm, offsets = _bin_args(x, y, vx, vy, vnorm, offsets)
    f = len(offsets) - 1
    out = np.empty((f, rows, cols, 4), dtype=np.float32)
    _lib().cm_bin_frames(_f64(x), _f64(y), _f64(vx), _f64(vy), _f64(vnorm), _i64(offsets),
                         f, rows, cols, ctypes.c_double(dx), ctypes.c_double(dy),
                         ctypes.c_double(lu[0]), ctypes.c_double(lu[1]),
                         ctypes.c_double(eps), _f32(out))
    return out


def bin_frames_reference(x, y, vx, vy, vnorm, offsets, *, rows: int, cols: int,
                         dx: float, dy: float, lu, eps: float = 1e-6) -> np.ndarray:
    x, y, vx, vy, vnorm, offsets = _bin_args(x, y, vx, vy, vnorm, offsets)
    out = np.zeros((len(offsets) - 1, rows, cols, 4), dtype=np.float32)
    ncell = rows * cols
    for fi in range(len(offsets) - 1):
        s, e = offsets[fi], offsets[fi + 1]
        i = np.abs(np.floor((y[s:e] - (lu[1] - 1)) / dy)).astype(np.int64)
        j = np.floor((x[s:e] - lu[0]) / dx).astype(np.int64)
        ok = (i >= 0) & (i < rows) & (j >= 0) & (j < cols)
        cell = (i * cols + j)[ok]
        rho = np.bincount(cell, minlength=ncell).astype(np.float64)
        svx = np.bincount(cell, weights=vx[s:e][ok], minlength=ncell)
        svy = np.bincount(cell, weights=vy[s:e][ok], minlength=ncell)
        svn = np.bincount(cell, weights=vnorm[s:e][ok], minlength=ncell)
        mean_vn = svn / (rho + eps)
        sdev = np.bincount(cell, weights=(vnorm[s:e][ok] - mean_vn[cell]) ** 2,
                           minlength=ncell)
        grid = np.stack([rho, svx / (rho + eps), svy / (rho + eps), sdev / (rho + eps)], -1)
        out[fi] = grid.reshape(rows, cols, 4).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# .cmb tensor IO: "CMB1" | int32 ndim | int64 shape[ndim] | float32 payload
# ---------------------------------------------------------------------------

def write_tensor(path: str, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    shape = np.array(arr.shape, dtype=np.int64)
    rc = _lib().cm_write_tensor(str(path).encode(), _f32(arr), _i64(shape), np.int32(arr.ndim))
    if rc != 0:
        raise OSError(f"cm_write_tensor failed ({rc}) for {path}")


def read_tensor(path: str) -> np.ndarray:
    lib = _lib()
    shape = np.zeros(8, dtype=np.int64)
    ndim = lib.cm_tensor_ndim(str(path).encode(), _i64(shape))
    if ndim <= 0:
        raise OSError(f"cm_tensor_ndim failed ({ndim}) for {path}")
    out = np.empty(int(np.prod(shape[:ndim])), dtype=np.float32)
    rc = lib.cm_read_tensor(str(path).encode(), _f32(out), out.size)
    if rc != 0:
        raise OSError(f"cm_read_tensor failed ({rc}) for {path}")
    return out.reshape(shape[:ndim])


def write_tensor_reference(path: str, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    with open(path, "wb") as fp:
        fp.write(b"CMB1")
        fp.write(np.int32(arr.ndim).tobytes())
        fp.write(np.array(arr.shape, dtype=np.int64).tobytes())
        fp.write(arr.tobytes())


def read_tensor_reference(path: str) -> np.ndarray:
    with open(path, "rb") as fp:
        if fp.read(4) != b"CMB1":
            raise OSError(f"bad magic in {path}")
        ndim = int(np.frombuffer(fp.read(4), np.int32)[0])
        shape = np.frombuffer(fp.read(8 * ndim), np.int64)
        data = np.frombuffer(fp.read(), np.float32)
        if data.size != int(np.prod(shape)):
            raise OSError(f"truncated payload in {path}")
        return data.reshape(shape).copy()
