"""Interpolation primitives (port of magphase_tpu/core/interp.py).

The reference leans on scipy.interpolate.interp1d for frame-rate conversion
(linear, axis 0) and phase-coefficient extension (nearest with edge
extrapolation); these are the dense equivalents.
"""
from __future__ import annotations

import torch


def as_f32(a, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, float64 narrowed to float32: the
    JAX package computes with 64-bit types off, so its jnp.asarray of a
    float64 host array is float32."""
    t = torch.as_tensor(a, device=device)
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def interp_linear_rows(x_grid: torch.Tensor, m_data: torch.Tensor,
                       x_new: torch.Tensor) -> torch.Tensor:
    """interp_linear_axis0 per row of a batch: grids (B, N), data (B, N,
    ...), queries (B, M) -> (B, M, ...)."""
    n = x_grid.shape[1]
    dt = torch.promote_types(x_grid.dtype, x_new.dtype)
    x_grid = x_grid.to(dt).contiguous()
    x_new = x_new.to(dt).contiguous()
    hi = torch.clamp(torch.searchsorted(x_grid, x_new, right=False), 1, n - 1)
    lo = hi - 1
    x_lo = torch.gather(x_grid, 1, lo)
    x_hi = torch.gather(x_grid, 1, hi)
    # tensor by tensor: torch computes a scalar over a tensor as a
    # reciprocal times the scalar, which rounds twice
    w = torch.clamp((x_new - x_lo) / torch.clamp(x_hi - x_lo, min=1e-12),
                    0.0, 1.0)
    rows = torch.arange(x_grid.shape[0], device=x_grid.device)[:, None]
    d_lo = m_data[rows, lo]
    d_hi = m_data[rows, hi]
    w = w.reshape(w.shape + (1,) * (m_data.ndim - 2))
    return d_lo + w * (d_hi - d_lo)


def interp_linear_axis0(x_grid, m_data, x_new, *,
                        device="cuda") -> torch.Tensor:
    """Linear interpolation of (N,) or (N, D) rows sampled at x_grid onto
    x_new, on ``device``.  Out-of-range queries clamp to the edge rows;
    x_grid must be non-decreasing (a repeated point takes the row after
    it)."""
    x_grid, m_data, x_new = (as_f32(a, device)
                             for a in (x_grid, m_data, x_new))
    return interp_linear_rows(x_grid[None], m_data[None], x_new[None])[0]


def extend_nearest_coeffs(m_data: torch.Tensor, n_out: int) -> torch.Tensor:
    """Nearest-neighbour extension of coefficient columns 0..n_in-1 to n_out
    columns, replicating interp1d(kind='nearest', fill_value='extrapolate')
    queried at integer positions (magphase.py:1225-1229): columns beyond the
    input range repeat the last input column."""
    n_in = m_data.shape[-1]
    idx = torch.clamp(torch.arange(n_out, device=m_data.device), max=n_in - 1)
    return torch.index_select(m_data, -1, idx)
