"""ctypes bindings for the C++ corpus-IO runtime (native/magphase_io.cpp),
the port of magphase_tpu/io/native.py.

The library is compiled from the repository's ``native/magphase_io.cpp``
with g++ at first use, into ``build/native_io/`` (named by a hash of the
source and the flags; nothing is written into ``native/``), and loaded
with ctypes.  Where g++ is missing or the build fails, every entry falls
back to the pure-Python codecs, as in the JAX package: this is host I/O,
not a device kernel.  ``available()`` says which one runs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "magphase_io.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native_io"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
# threads of one process share the temporary file's name: one builds
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmagphase_io_{h.hexdigest()[:16]}.so"


def build() -> bool:
    """Compile the library unless it is built already.  Returns True on
    success.  Concurrent processes each compile into a file of their own
    and rename it into place."""
    with _LOCK:
        return _build_locked()


def _build_locked() -> bool:
    path = library_path()
    if path.exists():
        return True
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)
    return True


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library, or None where it cannot be built."""
    if not build():
        return None
    lib = ctypes.CDLL(str(library_path()))
    lib.mp_read_wav.restype = ctypes.c_int64
    lib.mp_read_wav.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_void_p]
    lib.mp_write_wav.restype = ctypes.c_int32
    lib.mp_write_wav.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int32]
    lib.mp_read_binfile.restype = ctypes.c_int64
    lib.mp_read_binfile.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                    ctypes.c_int64]
    lib.mp_write_binfile.restype = ctypes.c_int32
    lib.mp_write_binfile.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int64]
    lib.mp_batch_read_wavs.restype = ctypes.c_int32
    lib.mp_batch_read_wavs.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
    return lib


def available() -> bool:
    return _load() is not None


def read_wav(path: str):
    """Native WAV read -> (float32 signal, fs); falls back to Python.

    The buffer is sized exactly from the RIFF header (a ~100-byte read),
    so arbitrarily long files decode without an artificial cap."""
    from .wav import read_wav as py_read
    from .wav import read_wav_info
    lib = _load()
    if lib is None:
        sig, fs = py_read(path)
        return np.asarray(sig, np.float32), fs
    total, _ = read_wav_info(path)
    out = np.empty(total, np.float32)
    fs = ctypes.c_int32(0)
    n = lib.mp_read_wav(path.encode(), out.ctypes.data, total,
                        ctypes.byref(fs))
    if n < 0:
        raise IOError(f"native wav read failed: {path}")
    return out[:n], int(fs.value)


def batch_read_wavs(paths: list[str], max_len: int,
                    n_threads: int | None = None):
    """Threaded padded batch load -> ((B, max_len) float32, lens, fss)."""
    lib = _load()
    B = len(paths)
    if lib is None:
        from .wav import read_wav as py_read
        out = np.zeros((B, max_len), np.float32)
        lens, fss = [], []
        for i, p in enumerate(paths):
            sig, fs = py_read(p)
            n = min(len(sig), max_len)
            out[i, :n] = sig[:n]
            lens.append(n)
            fss.append(fs)
        return out, np.asarray(lens), np.asarray(fss)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    blob = b"".join(p.encode() + b"\0" for p in paths)
    out = np.zeros((B, max_len), np.float32)
    lens = np.zeros(B, np.int64)
    fss = np.zeros(B, np.int32)
    rc = lib.mp_batch_read_wavs(blob, B, out.ctypes.data, max_len,
                                lens.ctypes.data, fss.ctypes.data,
                                n_threads)
    if rc != 0:
        raise IOError("native batch wav read failed")
    return out, lens, fss


def read_binfile(path: str, dim: int = 60):
    lib = _load()
    if lib is None:
        from .featfile import read_binfile as py_read
        return py_read(path, dim)
    size = os.path.getsize(path) // 4
    out = np.empty(size, np.float32)
    n = lib.mp_read_binfile(path.encode(), out.ctypes.data, size)
    if n != size:
        raise IOError(f"native binfile read failed: {path}")
    if size % dim != 0:
        raise ValueError(f"{path}: size {size} not divisible by dim {dim}")
    return np.squeeze(out.reshape(-1, dim).astype(np.float64))


def write_wav(path: str, sig: np.ndarray, fs: int) -> None:
    lib = _load()
    if lib is None:
        from .wav import write_wav as py_write
        py_write(path, sig, fs)
        return
    sig32 = np.ascontiguousarray(sig, np.float32)
    if lib.mp_write_wav(path.encode(), sig32.ctypes.data, len(sig32),
                        fs) != 0:
        raise IOError(f"native wav write failed: {path}")
