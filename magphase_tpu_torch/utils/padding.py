"""Shape bucketing helpers (port of magphase_tpu/utils/padding.py).

The port runs eagerly and needs no compile-variant bounding, but it keeps
the JAX package's buckets so that padded shapes — and with them the
synthesis FFT size, the batch split and every output sample — match the
reference package exactly.
"""
from __future__ import annotations

import numpy as np
import torch


def bucket(n: int, step: int) -> int:
    """Smallest multiple of ``step`` >= n (>= step)."""
    return max(step, int(np.ceil(n / step)) * step)


SIG_STEP = 1 << 15       # 32768 samples (~0.68 s @ 48 kHz)
FRM_STEP = 128           # frames


def _geom_grid(ratio: float = 1.25, max_units: int = 4096):
    """1, 2, 3, 4, 5, 7, 9, 12, ... — ~ratio-spaced integer unit counts."""
    grid = [1]
    while grid[-1] < max_units:
        grid.append(max(grid[-1] + 1, int(np.ceil(grid[-1] * ratio))))
    return np.asarray(grid)


_SIG_GRID = _geom_grid() * SIG_STEP

# Frame-element budget of one synthesis group: batch rows * frames *
# fft_len.  Kept at the JAX package's value so both packages split a
# request into the same groups; sizing it for the H100's memory is a
# separate change.
MAX_FRAME_ELEMS = 192 << 20


def bucket_signal(n: int) -> int:
    """Geometric signal-length bucket (multiples of SIG_STEP, ~1.25x
    spaced; linear SIG_STEP steps beyond the grid)."""
    i = int(np.searchsorted(_SIG_GRID, n))
    if i >= len(_SIG_GRID):
        return bucket(n, SIG_STEP)
    return int(_SIG_GRID[i])


_FRM_GRID = _geom_grid() * FRM_STEP


def bucket_frames(n: int) -> int:
    """Geometric frame-count bucket (multiples of FRM_STEP, ~1.25x
    spaced; linear FRM_STEP steps beyond the grid).  Phase 2 of the
    tracked analysis runs at this bucket of the realised mark count, as
    the JAX package does."""
    i = int(np.searchsorted(_FRM_GRID, n))
    if i >= len(_FRM_GRID):
        return bucket(n, FRM_STEP)
    return int(_FRM_GRID[i])


def pad_to(arr: np.ndarray, n: int, axis: int = 0, value=0) -> np.ndarray:
    """Pad a host array along ``axis`` to length ``n``."""
    pad = n - arr.shape[axis]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=value)


def pad_rows(a: torch.Tensor, n: int, value=0) -> torch.Tensor:
    """Pad a tensor's leading axis to ``n`` rows, on its own device."""
    pad = n - a.shape[0]
    if pad <= 0:
        return a
    return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), value)])
