"""Headerless float32 feature-file I/O, byte-compatible with the reference
(and Merlin): row-major float32, reshaped to (-1, dim) on read
(numpy-only copy of magphase_tpu/io/featfile.py).

Reference: ``lu.read_binfile`` / ``lu.write_binfile``
(the reference's src/libutils.py:112-127).
"""
from __future__ import annotations

import os

import numpy as np


def read_binfile(filename: str, dim: int = 60, squeeze: bool = True) -> np.ndarray:
    v_data = np.fromfile(filename, dtype=np.float32)
    if v_data.size % dim != 0:
        raise ValueError(
            f"{filename}: file size {v_data.size} not divisible by dim {dim}")
    m_data = v_data.reshape((-1, dim)).astype(np.float64)
    if squeeze:
        m_data = np.squeeze(m_data)
    return m_data


def write_binfile(m_data: np.ndarray, filename: str) -> None:
    m_data = np.asarray(m_data, dtype=np.float32)
    m_data.tofile(filename)


def write_featfile(m_data: np.ndarray, out_dir: str, filename: str) -> None:
    """Join path + write (magphase.py:2787-2791)."""
    write_binfile(m_data, os.path.join(out_dir, filename))
