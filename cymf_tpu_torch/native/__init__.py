"""The native host-side epoch prep: build, load and call.

``cymf_tpu_torch/csrc/native_prep.cpp`` is the port's own copy of the JAX
package's C++ OpenMP prep (``cymf_tpu/native/_native.cpp``) with the
CPython layer replaced by ``extern "C"`` functions over raw pointers.  It
is compiled at first use with the system ``g++ -O3 -std=c++17 -fopenmp
-fPIC -shared`` into ``build/cymf_tpu_torch/libcymf_prep_<hash>.so`` beside
the package, keyed by a hash of the source and the flags (written under a
temporary name and renamed into place, so that processes building at once
do not collide), and loaded with :mod:`ctypes`.  Importing this module
builds nothing.

Each entry point has a Python function here with the signature of the JAX
extension's (``cymf_tpu.native._native``), over numpy arrays in place of
byte buffers: it checks every length, dtype and range that the JAX C++
checks before its OpenMP region and raises ``ValueError`` where the JAX
package raises, allocates the outputs, and returns them as flat numpy
arrays (the JAX extension returns the same bytes).  The ``ctypes`` call
releases the interpreter lock, so a prep runs beside the main thread.

``HAVE_NATIVE`` (read lazily) is True when the library built and loaded;
:func:`lib` raises ``RuntimeError`` with the compiler's output when it did
not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "native_prep.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cymf_tpu_torch"
FLAGS = ("-O3", "-std=c++17", "-fopenmp", "-fPIC", "-shared")

_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "cymf_prep_threads": ([_I], _I),
    "cymf_cooccurrence": ([_P, _P, _L, _L, _L, _P], _P),
    "cymf_cooccurrence_take": ([_P, _P, _P], None),
    "cymf_bpr_prep_epoch_v2": ([_P, _P] + [_L] * 10 + [_P] * 5, _I),
    "cymf_pool_reject": ([_P, _P, _P] + [_L] * 4 + [_P], _I),
    "cymf_pool_reject_v2": ([_P, _P, _P, _L, _P] + [_L] * 3 + [_P], _I),
    "cymf_build_key_filter": ([_P, _L, _L, _P], _I),
    "cymf_pool_reject_v3": ([_P, _P, _P, _L, _P, _P] + [_L] * 4 + [_P], _I),
    "cymf_bpr_prep_epoch_v3": ([_P, _P, _L, _P, _P] + [_L] * 10 + [_P] * 5,
                               _I),
    "cymf_relmf_prep_epoch": ([_P, _L, _P, _P] + [_L] * 12 + [_P] * 7, _I),
}

_lib = None
_error: RuntimeError | None = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libcymf_prep_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless one for this source and these flags
    exists.  Returns its path; raises ``RuntimeError`` with the
    compiler's output if ``g++`` is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native prep cannot be built "
                           "(CYMF_TPU_PREP=numpy runs the numpy prep)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use; raises ``RuntimeError``
    (the same one on every call) if it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                handle = ctypes.CDLL(str(build()))
            except OSError as e:
                _error = RuntimeError(f"cannot load the native prep: {e}")
            except RuntimeError as e:
                _error = e
            else:
                for name, (argtypes, restype) in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes, fn.restype = argtypes, restype
                _lib = handle
        if _lib is None:
            raise _error
        return _lib


def __getattr__(name: str):
    if name == "HAVE_NATIVE":
        try:
            lib()
        except RuntimeError:
            return False
        return True
    raise AttributeError(name)


def num_threads() -> int:
    """The OpenMP thread count of the library's calls."""
    return lib().cymf_prep_threads(-1)


def set_num_threads(n: int) -> int:
    """Sets the library's OpenMP thread count (0: the OpenMP runtime's
    default, ``OMP_NUM_THREADS`` or the core count) and returns it."""
    return lib().cymf_prep_threads(int(n))


def _arr(a, dtype, what: str, size: int | None = None) -> np.ndarray:
    """``a`` as a C-contiguous array of ``dtype`` (raises ``ValueError`` on
    another dtype, or on ``size`` elements expected and not found)."""
    a = np.ascontiguousarray(a)
    if a.dtype != dtype:
        raise ValueError(f"{what} must be {np.dtype(dtype).name}, not "
                         f"{a.dtype.name}")
    if size is not None and a.size != size:
        raise ValueError(f"{what} holds {a.size} values, not {size}")
    return a


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _indptr(indptr, keys: np.ndarray, U: int, name: str) -> np.ndarray:
    ip = _arr(indptr, np.int64, f"{name}: indptr", U + 1)
    if ip[0] != 0 or ip[U] != keys.size:
        raise ValueError(f"{name}: indptr must span pos_keys exactly")
    return ip


def _filter(filt, log2_bits: int, name: str) -> np.ndarray:
    if not 10 <= log2_bits <= 36:
        raise ValueError(f"{name}: log2_bits in [10, 36] required")
    return _arr(filt, np.uint64, f"{name}: filter", (1 << log2_bits) // 64)


def _seed(seed) -> int:
    """``seed`` as an int64, as the JAX extension parses it (ctypes would
    wrap a larger one silently)."""
    seed = int(seed)
    if not -2**63 <= seed < 2**63:
        raise OverflowError("seed does not fit an int64")
    return seed


def _bad_range(rc: int, name: str) -> None:
    if rc != 0:
        raise ValueError(f"{name}: indptr not nondecreasing in range")


def cooccurrence(flat, lens, vocab_size: int, window_size: int):
    """Left-window 1/distance co-occurrence accumulation over the lines
    ``flat`` (int64 ids, line after line) of lengths ``lens`` (int64):
    ``(keys int64[nnz], vals float64[nnz])`` with ``key = center + context
    * vocab_size``, in the order of the JAX extension's hash map."""
    flat = _arr(flat, np.int64, "cooccurrence: flat")
    lens = _arr(lens, np.int64, "cooccurrence: lens")
    if (lens < 0).any() or int(lens.sum()) > flat.size:
        raise ValueError("cooccurrence: line lengths must be nonnegative "
                         "and sum to at most len(flat)")
    nnz = ctypes.c_int64()
    handle = lib().cymf_cooccurrence(_ptr(flat), _ptr(lens), lens.size,
                                     int(vocab_size), int(window_size),
                                     ctypes.addressof(nnz))
    keys = np.empty(nnz.value, np.int64)
    vals = np.empty(nnz.value, np.float64)
    lib().cymf_cooccurrence_take(handle, _ptr(keys), _ptr(vals))
    return keys, vals


def _prep_dims(name, S, B, U, I, slots, rh, wrows, tile) -> None:
    if min(S, B, U, I, slots, wrows, tile, rh) <= 0 or rh % wrows:
        raise ValueError(f"{name}: dimensions must be positive and rh a "
                         "multiple of wrows")
    if -(-I // slots) > rh:
        raise ValueError(f"{name}: rh must cover ceil(I/slots) physical "
                         "rows")


def _prep_outputs(S, B, rh, wrows):
    n = S * B
    return (np.empty(n, np.int32), np.empty(n, np.float32),
            np.empty(n, np.int32), np.empty(n, np.int32),
            np.empty(S * 2 * (rh // wrows), np.int32))


def bpr_prep_epoch_v2(u2, pos_keys, S: int, B: int, U: int, I: int,
                      slots: int, rh: int, wrows: int, tile: int, seed: int):
    """Per-epoch BPR prep (draws, rejection by a search over all keys,
    j-side counting sort and windows): ``(j2 int32, mask float32, sj
    int32, rowsj int32, winj int32)``, flat, in the layouts ``[S, B]``,
    ``[S, B]``, ``[S, B]``, ``[S, B]``, ``[S, 2, rh / wrows]``."""
    name = "bpr_prep_epoch_v2"
    _prep_dims(name, S, B, U, I, slots, rh, wrows, tile)
    u2 = _arr(u2, np.int32, f"{name}: u2", S * B)
    keys = _arr(pos_keys, np.int64, f"{name}: pos_keys")
    out = _prep_outputs(S, B, rh, wrows)
    lib().cymf_bpr_prep_epoch_v2(_ptr(u2), _ptr(keys), keys.size, S, B, U,
                                 I, slots, rh, wrows, tile, _seed(seed),
                                 *map(_ptr, out))
    return out


def bpr_prep_epoch_v3(u2, pos_keys, indptr, filt, S: int, B: int, U: int,
                      I: int, slots: int, rh: int, wrows: int, tile: int,
                      seed: int, log2_bits: int):
    """:func:`bpr_prep_epoch_v2` with the filter-accelerated rejection
    (the same streams, bit for bit)."""
    name = "bpr_prep_epoch_v3"
    _prep_dims(name, S, B, U, I, slots, rh, wrows, tile)
    u2 = _arr(u2, np.int32, f"{name}: u2", S * B)
    keys = _arr(pos_keys, np.int64, f"{name}: pos_keys")
    ip = _indptr(indptr, keys, U, name)
    bits = _filter(filt, log2_bits, name)
    out = _prep_outputs(S, B, rh, wrows)
    _bad_range(lib().cymf_bpr_prep_epoch_v3(
        _ptr(u2), _ptr(keys), keys.size, _ptr(ip), _ptr(bits), S, B, U, I,
        slots, rh, wrows, tile, _seed(seed), log2_bits, *map(_ptr, out)),
        name)
    return out


def _pool_args(name, u, j, n, U, I):
    if min(n, U, I) <= 0:
        raise ValueError(f"{name}: dimensions must be positive")
    return (_arr(u, np.int32, f"{name}: u", n),
            _arr(j, np.int32, f"{name}: j", n), np.empty(n, np.float32))


def pool_reject(u, j, pos_keys, n: int, U: int, I: int):
    """Rejection mask (float32 [n]): 1 where ``u < U`` and ``(u, j)`` is
    not a positive, by a search over all keys."""
    u, j, mask = _pool_args("pool_reject", u, j, n, U, I)
    keys = _arr(pos_keys, np.int64, "pool_reject: pos_keys")
    lib().cymf_pool_reject(_ptr(u), _ptr(j), _ptr(keys), keys.size, n, U, I,
                           _ptr(mask))
    return mask


def pool_reject_v2(u, j, pos_keys, indptr, n: int, U: int, I: int):
    """:func:`pool_reject` by per-user ranges ``indptr`` of the keys."""
    name = "pool_reject_v2"
    u, j, mask = _pool_args(name, u, j, n, U, I)
    keys = _arr(pos_keys, np.int64, f"{name}: pos_keys")
    ip = _indptr(indptr, keys, U, name)
    _bad_range(lib().cymf_pool_reject_v2(_ptr(u), _ptr(j), _ptr(keys),
                                         keys.size, _ptr(ip), n, U, I,
                                         _ptr(mask)), name)
    return mask


def pool_reject_v3(u, j, pos_keys, indptr, filt, n: int, U: int, I: int,
                   log2_bits: int):
    """:func:`pool_reject_v2` behind the one-bit filter ``filt``."""
    name = "pool_reject_v3"
    u, j, mask = _pool_args(name, u, j, n, U, I)
    keys = _arr(pos_keys, np.int64, f"{name}: pos_keys")
    ip = _indptr(indptr, keys, U, name)
    bits = _filter(filt, log2_bits, name)
    _bad_range(lib().cymf_pool_reject_v3(
        _ptr(u), _ptr(j), _ptr(keys), keys.size, _ptr(ip), _ptr(bits), n, U,
        I, log2_bits, _ptr(mask)), name)
    return mask


def build_key_filter(keys, log2_bits: int):
    """The one-bit-per-hash filter over ``keys`` (int64):
    ``uint64[2**log2_bits / 64]``."""
    if not 10 <= log2_bits <= 36:
        raise ValueError("build_key_filter: log2_bits in [10, 36] and int64 "
                         "keys required")
    keys = _arr(keys, np.int64, "build_key_filter: keys")
    bits = np.empty((1 << log2_bits) // 64, np.uint64)
    lib().cymf_build_key_filter(_ptr(keys), keys.size, log2_bits,
                                _ptr(bits))
    return bits


def relmf_prep_epoch(pos_keys, indptr, filt, S: int, B: int, U: int, I: int,
                     slots: int, rw: int, rh: int, wrows_w: int,
                     wrows_h: int, tile: int, seed: int, log2_bits: int):
    """Per-epoch RelMF prep (cell draws, labels, the W-side counting sort
    by packed row and the item side over it): ``(u2, i2, lab uint8, winw,
    si, rowsi, wini)``, flat, in the layouts ``[S, B]`` (``winw``
    ``[S, 2, rw / wrows_w]``, ``wini`` ``[S, 2, rh / wrows_h]``)."""
    name = "relmf_prep_epoch"
    if (min(S, B, U, I, slots, wrows_w, wrows_h, tile, rw, rh) <= 0
            or rw % wrows_w or rh % wrows_h):
        raise ValueError(f"{name}: dimensions must be positive, rw/rh "
                         "multiples of their wrows")
    if -(-U // slots) > rw or I > rh:
        raise ValueError(f"{name}: rw/rh must cover the tables")
    keys = _arr(pos_keys, np.int64, f"{name}: pos_keys")
    ip = _indptr(indptr, keys, U, name)
    # the JAX code searches each user's range unchecked: refuse a range
    # that would leave the keys
    _bad_range(int((np.diff(ip) < 0).any()), name)
    bits = _filter(filt, log2_bits, name)
    n = S * B
    out = (np.empty(n, np.int32), np.empty(n, np.int32),
           np.empty(n, np.uint8), np.empty(S * 2 * (rw // wrows_w), np.int32),
           np.empty(n, np.int32), np.empty(n, np.int32),
           np.empty(S * 2 * (rh // wrows_h), np.int32))
    lib().cymf_relmf_prep_epoch(
        _ptr(keys), keys.size, _ptr(ip), _ptr(bits), S, B, U, I, slots, rw,
        rh, wrows_w, wrows_h, tile, _seed(seed), log2_bits, *map(_ptr, out))
    return out
