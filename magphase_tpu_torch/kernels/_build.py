"""Build and load the port's CUDA C++ kernel libraries.

Each source under ``csrc/`` is compiled with nvcc for sm_90a into its own
shared library with a plain C interface, in ``build/torch_kernels/``,
named by a hash of the source and the flags, and loaded with ctypes.
``build`` starts one nvcc per source that is not built yet, all at once,
and waits for them together.  Nothing is built at import: the first
launch on a CUDA tensor builds its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the pipelined entries' stage threads may reach a first launch together:
# one builds, the others wait and find the library built (the temporary
# files are named by process only)
_LOCK = threading.Lock()
# the launch counts' read-modify-write: the shards of a mesh launch from
# threads of their own (parallel/mesh.py:run_sharded)
_COUNT_LOCK = threading.Lock()


def find_nvcc() -> str:
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    cands = [shutil.which("nvcc")] + [os.path.join(h, "bin", "nvcc")
                                      for h in homes if h]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmp_{source.stem}_{h.hexdigest()[:16]}.so"


def build(*sources: Path) -> dict:
    """Compile each source unless a library built from the same source and
    flags exists; the nvcc processes run concurrently.  Returns
    {source stem: {path, seconds, log, cached}}; ``log`` holds the
    compiler's output (the ptxas register/spill report)."""
    with _LOCK:
        return _build_locked(sources)


def _build_locked(sources) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for src in sources:
        path = library_path(src)
        log_path = path.with_suffix(".log")
        if path.exists():
            log = log_path.read_text() if log_path.exists() else ""
            out[src.stem] = dict(path=str(path), seconds=0.0, log=log,
                                 cached=True)
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, path, tmp, proc, time.perf_counter()))
    failed = []
    for src, path, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{src.name}: nvcc failed ({proc.returncode}):\n"
                          f"{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
        out[src.stem] = dict(path=str(path), seconds=seconds, log=log,
                             cached=False)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(source: Path) -> ctypes.CDLL:
    """The library built from ``source``, built first if need be (each
    wrapper module loads its library once).  Every library exports
    ``mp_error_string(int) -> const char*``."""
    lib = ctypes.CDLL(build(source)[source.stem]["path"])
    lib.mp_error_string.argtypes = [ctypes.c_int]
    lib.mp_error_string.restype = ctypes.c_char_p
    return lib


def launch(lib: ctypes.CDLL, fn_name: str, device: torch.device,
           *args) -> None:
    """Call a C entry point with the device's current stream as its last
    argument; raise on a non-zero cudaError_t."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}: "
                           f"{lib.mp_error_string(rc).decode()}")


def count_launch(wrapper) -> None:
    """One more launch of ``wrapper`` (``wrapper.launches += 1`` under a
    lock, so launches from several threads all count).  The wrapper is
    looked up in its module at call time, so a stand-in that a caller put
    in its place (chip_smoke.py's recorder) sees the count."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has the device, dtype and shape a kernel takes
    and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_int_range(**dims) -> None:
    for k, v in dims.items():
        if not 0 <= v < 2 ** 31:
            raise ValueError(f"{k}={v} out of the kernels' int32 range")


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {t.device}; the plain version "
                         "runs on the CPU and the kernel on CUDA only")
