"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes` — no
PyTorch headers, so a build takes seconds.  Builds happen at first use, into
``build/repro_torch/`` at the repository root (git-ignored; override with
``REPRO_TORCH_BUILD_DIR``), keyed by a hash of the sources and flags, so a
stale library is never loaded.  :func:`build_all` starts one ``nvcc`` per
source, all in parallel.

Nothing here falls back: a missing compiler or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("w4a16_matmul", "w4a8_matmul", "gqa_paged_decode",
           "gqa_paged_prefill", "w4a16_grouped", "w4a8_grouped",
           "flash_attention", "mla_paged_decode", "mla_paged_prefill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# element-type codes of csrc/common.cuh
DTYPE_F32 = 0
DTYPE_BF16 = 1
DTYPE_I8 = 2

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from src/repro_torch/csrc at first use on the GPU machine")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path):
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _start(name: str):
    """Start the nvcc build of ``name`` (None if already built)."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(_nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Build every kernel library, one nvcc per source in parallel.
    Returns the wall time in seconds (0 when all were cached)."""
    t0 = time.perf_counter()
    with _LOCK:
        started = {n: _start(n) for n in SOURCES}
        for n, s in started.items():
            _finish(n, s)
    return time.perf_counter() - t0 if any(started.values()) else 0.0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            _finish(name, _start(name))
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return _LIBS[name]


def cfunc(name: str, argtypes):
    """The C launcher ``repro_<name>`` of ``csrc/<name>.cu`` with its ctypes
    signature (every launcher returns a cudaError_t as int)."""
    fn = getattr(load(name), f"repro_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def vp(t) -> ctypes.c_void_p:
    """The device pointer of tensor ``t`` (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The number of SMs of CUDA ``device`` (a tensor's ``.device``; cached,
    since the wrappers ask at every launch)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
