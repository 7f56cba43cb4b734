"""Small file/array helpers (copy of magphase_tpu/utils/futil.py, which
imports no JAX; libutils.py parity).

The reference's remaining generic utilities (libutils.py:66-202) that are
not already covered by ``io``: index vectors, rounding, path parsing,
collision-free temp names, dimensionality guard.
"""
from __future__ import annotations

import datetime
import os
import socket

import numpy as np


def round_to_int(x):
    """Round-half-to-even then int (libutils.py:128-131)."""
    return np.round(x).astype(int)


def indexes_to_one_zero_vector(v_nxs, length: int) -> np.ndarray:
    """One-hot-by-index vector (libutils.py:79-88)."""
    v = np.zeros(length)
    v[np.asarray(v_nxs).astype(int)] = 1
    return v


def read_text_file2(*args, **kwargs) -> np.ndarray:
    """np.genfromtxt with the 1-element-squeeze bug protected
    (libutils.py:98-102).  The reference's ``dtype='string'`` spelling is
    mapped to str."""
    if kwargs.get("dtype") == "string":
        kwargs["dtype"] = str
    return np.atleast_1d(np.genfromtxt(*args, **kwargs))


def fileparts(fullpath: str) -> list:
    """[path, filetoken, ext, path_with_token] (libutils.py:133-138)."""
    path_with_token, ext = os.path.splitext(fullpath)
    path, _filename = os.path.split(fullpath)
    filetoken = os.path.basename(path_with_token)
    return [path, filetoken, ext, path_with_token]


def ins_pid(filepath: str) -> str:
    """path/file.ext -> path/file_host_pid.ext — collision-free temp names
    (libutils.py:187-195).  Kept for users' own temp files; the framework
    itself no longer needs subprocess temp files."""
    filename, ext = os.path.splitext(filepath)
    return "%s_%s_%d%s" % (filename, socket.gethostname(), os.getpid(), ext)


def ins_date_time(filepath: str, prefix: str = "") -> str:
    """path/file.ext -> path/file[_prefix]_YYYYMMDD_HHMMSS.ext
    (libutils.py:197-202)."""
    filename, ext = os.path.splitext(filepath)
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    if prefix:
        return "%s_%s_%s%s" % (filename, prefix, stamp, ext)
    return "%s_%s%s" % (filename, stamp, ext)


def is_mutable(data) -> bool:
    return hasattr(data, "__setitem__")


class DimProtect:
    """1-D <-> 2-D in-place shape guard (libutils.py:164-177): resizes 1-D
    arrays to column vectors on entry; ``end`` restores them."""

    def __init__(self, *args):
        self.orig_ndim = args[0].ndim
        if self.orig_ndim == 1:
            for data in args:
                data.resize((data.size, 1))

    def end(self, *args):
        if self.orig_ndim == 1:
            for data in args:
                data.resize((data.shape[0],))
