"""Build, load and count the hand-written CUDA kernels.

The sources under ``cymf_tpu_torch/csrc/`` are compiled at first use with
``nvcc`` for ``sm_90a``, one ``nvcc`` process per source, all started
together, and linked into one shared library with a plain C interface,
``build/cymf_tpu_torch/libcymf_kernels_<hash>.so`` beside the package,
keyed by a hash of the sources, and loaded with :mod:`ctypes`.  Nothing
includes PyTorch's headers, so the build takes seconds.  Importing this
module builds nothing: the CPU tests import every module of the port.

Each C entry point takes device pointers, ints and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; every wrapper calls it
through :func:`launch`, which raises on anything but 0.  A failed build
raises too: there is no fallback.

The kernels, by source and the wrapper that launches them:

- ``bpr_sample.cu``: ``fused_sample.bpr_sample_phase``;
- ``bpr_fused.cu``: ``fused_sample.bpr_sample_phase_v5``,
  ``fused_step.bpr_block_step_v6``, ``fused_step.bpr_range_step_v7`` and
  ``fused_step.bpr_pool_step_v8`` (the per-sample math of these and of
  ``bpr_sample.cu`` is the one device function of ``bpr_math.cuh``; the
  segmented reduction of v6-v8 is ``segment.cuh``'s, shared with
  ``sorted_accum.cu``);
- ``glove_sample.cu``: ``glove_epoch.glove_sample_phase`` (GloVe and
  RelMF);
- ``sorted_accum.cu``: ``sorted_accum.sorted_accum`` and
  ``sorted_accum.sorted_accum_dual`` (counted as ``sorted_accum_wide`` and
  ``sorted_accum_dual_wide`` where they take the wide form; both run
  ``segment.cuh``'s segmented reduction);
- ``chol_inv.cu``: ``chol_kernel.chol_inv_batched``;
- ``probes.cu``: ``probes.phase_v4r``, ``probes.copy_phase`` and
  ``probes.gather_rows`` (the probes P1-P3);
- ``seq_epoch.cu``: ``pallas_engine.bpr_pallas_epoch``,
  ``pallas_engine.relmf_pallas_epoch`` and
  ``pallas_engine.glove_pallas_epoch``.

:data:`launches` counts kernel launches per wrapper.  :func:`launch` adds
one where it launches a kernel, and nothing else adds to it, so a run can
show that the main path went through each kernel.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cymf_tpu_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

launches: collections.Counter = collections.Counter()

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# entry point -> argument types (pointers, ints, floats; the stream last)
_SIGNATURES = {
    "cymf_bpr_sample_blocks": [_I],
    "cymf_bpr_sample_phase": [_P] * 7 + [_I] * 4 + [_F, _P],
    "cymf_bpr_v5_blocks": [_I],
    "cymf_bpr_sample_phase_v5": [_P] * 9 + [_I] * 6 + [_F, _P],
    "cymf_bpr_block_step_v6": [_P] * 10 + [_L] + [_I] * 7 + [_F, _P],
    "cymf_bpr_range_step_v7": [_P] * 9 + [_L] + [_I] * 7 + [_F, _P],
    "cymf_bpr_pool_step_v8": [_P] * 11 + [_L] + [_I] * 8 + [_F, _P],
    "cymf_glove_sample_blocks": [_I],
    "cymf_glove_sample_phase": [_P] * 6 + [_I] * 4 + [_P],
    "cymf_sorted_accum_plan": [_I, _I, _I, _P],
    "cymf_sorted_accum": [_P] * 4 + [_L] + [_I] * 4 + [_P],
    "cymf_sorted_accum_dual_plan": [_I] * 4 + [_P],
    "cymf_sorted_accum_dual": [_P] * 6 + [_L] + [_I] * 6 + [_P],
    "cymf_phase_v4r_blocks": [_I],
    "cymf_phase_v4r": [_P] * 7 + [_I] * 4 + [_F, _P],
    "cymf_copy_phase": [_P] * 6 + [_L, _I, _P],
    "cymf_gather_rows_occupancy": [_I, _I],
    "cymf_gather_rows": [_P] * 3 + [_I] * 6 + [_P],
    "cymf_chol_inv_batched": [_P, _L, _L, _P, _P, _I, _I, _P],
    "cymf_seq_epoch_max_group": [],
    "cymf_seq_epoch_plan": [_I] * 3,
    "cymf_bpr_seq_epoch": [_P, _P, _I, _I] + [_P] * 4 + [_L] + [_I] * 5
    + [_F] * 7 + [_P, _P],
    "cymf_relmf_seq_epoch": [_P, _P, _I, _I] + [_P] * 4 + [_L] + [_I] * 5
    + [_F] * 7 + [_P, _P],
    "cymf_glove_seq_epoch": [_P, _P, _I, _I] + [_P] * 5 + [_L] + [_I] * 5
    + [_F, _P, _P],
}

_lib = None


def reset_launches() -> None:
    launches.clear()


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcymf_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these exact sources
    exists.  Returns its path; raises ``RuntimeError`` with the compiler's
    output if ``nvcc`` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    tmp = out.with_suffix(f".{tag}.tmp")
    link = [nvcc, ARCH, "-shared", "-o", str(tmp),
            *[str(obj) for _, obj, _ in jobs]]
    try:
        logs = [(cmd, p.communicate()[0], p.returncode) for cmd, _, p in jobs]
        for cmd, log, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                                   f"{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
    finally:
        for _, obj, p in jobs:
            if p.poll() is None:
                p.kill()
                p.wait()
            obj.unlink(missing_ok=True)
    if verbose:
        print("".join(log for _, log, _ in logs))
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.cymf_error_string.argtypes = [ctypes.c_int]
        handle.cymf_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().cymf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def launch(name: str, device: torch.device, *args,
           entry: str | None = None) -> None:
    """Calls the C entry point ``entry`` (``cymf_<name>`` by default) on
    ``device`` with ``args`` (tensors as their device pointers) and
    PyTorch's current stream last; raises on a launch error, else counts
    one launch of ``name``."""
    with torch.cuda.device(device):
        err = getattr(lib(), entry or f"cymf_{name}")(
            *(a.data_ptr() if torch.is_tensor(a) else a for a in args),
            stream(device))
    check(err, name)
    launches[name] += 1


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take
    it."""
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, ndim: int | None = None) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor
    on ``device``, 16-byte aligned if it holds floats (the kernels read
    float rows as ``float4``)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.is_floating_point() and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
