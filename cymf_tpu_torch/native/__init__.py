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

The once-a-fit static entries at the end (:func:`sort_batches`,
:func:`sorted_side`, :func:`sorted_windows`, :func:`spans_fit`) have no
JAX counterpart: they return what the numpy code of
``models/bpr.py::sorted_batches`` and ``ops/packed_epoch.py`` returns.

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
    "cymf_sort_batches": ([_P, _P] + [_L] * 4 + [ctypes.c_int32, _P, _P],
                          _I),
    "cymf_sorted_side": ([_P] + [_L] * 6 + [_P] * 3, _I),
    "cymf_sorted_windows": ([_P] + [_L] * 7 + [_P], _I),
    "cymf_spans_fit": ([_P] + [_L] * 6 + [_P], _I),
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


# ---------------------------------------------------------------------------
# once-a-fit static streams (the port's own entries: the JAX package sorts
# these with numpy)
# ---------------------------------------------------------------------------

def _ids(a, what: str) -> np.ndarray:
    """Integer ids as a C-contiguous int32 array.  Another integer dtype is
    converted when every id lies in ``[0, 2**31)``; int32 ids are checked
    for sign by the library itself."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.int32:
        return a
    if a.dtype.kind not in "iu":
        raise ValueError(f"{what} must be integer ids, not {a.dtype.name}")
    if a.size and (a.min() < 0 or a.max() >= 2**31):
        raise ValueError(f"{what}: ids outside [0, 2**31)")
    return a.astype(np.int32)


def _steps(a, what: str, fold: bool = False):
    """An ``[S, B]`` id stream as int32 and its ``(S, B)``; ``fold``: ``B``
    must be a multiple of 128 (the folded ``[S, B / 128, 128]`` rows)."""
    a = _ids(a, what)
    if a.ndim != 2 or min(a.shape) <= 0 or (fold and a.shape[1] % 128):
        raise ValueError(f"{what} must be [S, B] with S, B > 0"
                         + (" and B a multiple of 128" if fold else ""))
    return a, a.shape[0], a.shape[1]


def _window_dims(name, rows, wrows, tile, B):
    """The ``Bn`` of :func:`~cymf_tpu_torch.ops.sorted_accum.window_ranges`
    with ``align=128`` (the step's length rounded up to a tile)."""
    if min(rows, wrows, tile) <= 0 or rows % wrows or tile % 128:
        raise ValueError(f"{name}: rows a positive multiple of wrows and "
                         "tile a multiple of 128 required")
    return -(-B // tile) * tile


def _negative(rc: int, name: str) -> None:
    if rc != 0:
        raise ValueError(f"{name}: negative id")


def sort_batches(users, positives, S: int, B: int, U: int, pad: int):
    """The ``S x B`` minibatches of ``users``/``positives`` (int ids of
    one length, at most ``S * B``), padded with user ``pad`` and item 0,
    each step sorted stably by user: ``(u2, i2)``, int32 ``[S, B]``, what
    a stable ``argsort`` of each step gives.  Users lie in ``[0, U)`` or
    equal ``pad`` (``>= U``); another raises ``ValueError``."""
    name = "sort_batches"
    users = _ids(users, f"{name}: users").ravel()
    positives = _ids(positives, f"{name}: positives").ravel()
    n = users.size
    if (positives.size != n or min(S, B) <= 0 or n > S * B or U < 0
            or B >= 2**31 or not U <= pad < 2**31):
        raise ValueError(f"{name}: users and positives of one length n <= "
                         "S * B, B < 2**31 and U <= pad < 2**31 required")
    u2 = np.empty((S, B), np.int32)
    i2 = np.empty((S, B), np.int32)
    if lib().cymf_sort_batches(_ptr(users), _ptr(positives), n, S, B, U,
                               pad, _ptr(u2), _ptr(i2)) != 0:
        raise ValueError(f"{name}: a user outside [0, {U})")
    return u2, i2


def sorted_side(v2, rows: int, wrows: int, tile: int):
    """Each step of the ``[S, B]`` ids ``v2`` (``B`` a multiple of 128)
    sorted stably, and the windows of ``window_ranges(sorted ids, rows,
    wrows, tile, align=128)``: ``(perm [S, B], sorted ids [S, B / 128,
    128], windows [S, 2, rows / wrows])``, int32, what
    ``ops/packed_epoch.py::_sorted_side``'s numpy body gives.  Ids at or
    past ``rows`` sort last, by id.  Negative ids raise ``ValueError``."""
    name = "sorted_side"
    v2, S, B = _steps(v2, f"{name}: ids", fold=True)
    Bn = _window_dims(name, rows, wrows, tile, B)
    perm = np.empty((S, B), np.int32)
    srows = np.empty((S, B // 128, 128), np.int32)
    win = np.empty((S, 2, rows // wrows), np.int32)
    _negative(lib().cymf_sorted_side(_ptr(v2), S, B, rows, wrows, tile, Bn,
                                     _ptr(perm), _ptr(srows), _ptr(win)),
              name)
    return perm, srows, win


def sorted_windows(v2, slots: int, rows: int, wrows: int, tile: int):
    """The windows of each step of ``v2`` (``[S, B]`` ids ascending by row
    ``id // slots``), as ``window_ranges(align=128)`` gives them, by binary
    search: int32 ``[S, 2, rows / wrows]``.  A negative id (a step's first,
    its least) raises ``ValueError``."""
    name = "sorted_windows"
    v2, S, B = _steps(v2, f"{name}: ids")
    Bn = _window_dims(name, rows, wrows, tile, B)
    if slots <= 0:
        raise ValueError(f"{name}: slots must be positive")
    win = np.empty((S, 2, rows // wrows), np.int32)
    _negative(lib().cymf_sorted_windows(_ptr(v2), S, B, slots, rows, wrows,
                                        tile, Bn, _ptr(win)), name)
    return win


def spans_fit(u2, slots: int, stride: int, margin: int, rw: int) -> bool:
    """True iff every ``stride``-sample chunk of each step's row stream
    ``u2 // slots`` (``[S, B]``, ascending, ``stride`` dividing ``B``) has
    its rows below ``rw`` within ``margin`` rows of its first row, or its
    first row past ``rw - margin``, or no row below ``rw``: the packed
    engine's span gate (``ops/packed_epoch.py::_spans_fit``).  Negative
    ids raise ``ValueError``."""
    name = "spans_fit"
    u2, S, B = _steps(u2, f"{name}: ids")
    if min(slots, stride) <= 0 or B % stride:
        raise ValueError(f"{name}: stride must divide the step")
    fits = ctypes.c_int64()
    _negative(lib().cymf_spans_fit(_ptr(u2), S, B, slots, stride, margin,
                                   rw, ctypes.addressof(fits)), name)
    return bool(fits.value)
