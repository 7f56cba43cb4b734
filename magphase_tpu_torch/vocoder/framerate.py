"""Variable (pitch-synchronous) <-> constant frame-rate conversion (port of
magphase_tpu/vocoder/framerate.py).

Reference: interp_from_variable_to_const_frm_rate (magphase.py:2219-2239),
interp_from_const_to_variable_rate (magphase.py:2242-2252),
get_shifts_and_frm_locs_from_const_shifts (magphase.py:1426-1449, a
sequential backward walk), shift_to_f0/f0_to_shift (magphase.py:2198-2215).

The walk runs on the host in float64 (its integer truncation must match
the reference bit for bit); the dense feature interpolation runs on the
device in float32, as the JAX package computes it with 64-bit types off.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.interp import as_f32, interp_linear_axis0, interp_linear_rows
from ..core.spectral import MAGIC


def shift_to_f0_np(v_shift, v_voi, fs: int, out: str = "f0",
                   b_smooth: bool = True) -> np.ndarray:
    """magphase.py:2198-2207 (host, float64; medfilt kernel 3)."""
    from scipy import signal
    v_f0 = np.asarray(v_voi, np.float64) * fs / np.asarray(v_shift, np.float64)
    if b_smooth:
        v_f0 = v_voi * signal.medfilt(v_f0)
    if out == "lf0":
        with np.errstate(divide="ignore"):
            v_lf0 = np.log(v_f0)
        v_lf0[np.isinf(v_lf0)] = MAGIC
        return v_lf0
    return v_f0


def f0_to_shift_np(v_f0_in, fs: int,
                   unv_frm_rate_ms: float = 5.0) -> np.ndarray:
    """magphase.py:2210-2215: unvoiced (f0 == 0) frames at the 5 ms rate."""
    v_f0 = np.asarray(v_f0_in, np.float64).copy()
    v_f0[v_f0 == 0] = 1000.0 / unv_frm_rate_ms
    return fs / v_f0


def truncate_shifts(v_shift: np.ndarray) -> np.ndarray:
    """Float shifts -> integer samples with the reference's truncation
    semantics (``v_shift.astype(int)``, magphase.py:879) made stable
    against float round-trip noise.

    Analysis derives f0 = fs/shift from integer shifts; synthesis inverts
    it as int(fs/exp(log(f0))), and the exp/log round trip (1 ulp in f64,
    ~3e-7 relative through a float32 feature file) lands a hair below the
    integer, so bare truncation yields shift-1 on a coin flip per frame.
    A relative guard of 1e-5 — far above the float noise, far below any
    intended fractional shift — restores exactness; values not within
    1e-5 of an integer truncate exactly as the reference does."""
    v = np.asarray(v_shift, np.float64)
    return np.floor(v * (1.0 + 1e-5)).astype(np.int64)


def _rows_1d(m_data, device):
    """(m as (N, D) float tensor on ``device``, whether it was 1-D)."""
    m = as_f32(m_data, device)
    return (m[:, None], True) if m.ndim == 1 else (m, False)


def interp_from_variable_to_const_frm_rate(m_data, v_pm_smpls,
                                           const_rate_ms: float, fs: int, *,
                                           device="cuda") -> torch.Tensor:
    """Variable -> constant grid (magphase.py:2219-2239), on ``device``.

    Grid points: const_rate_smpls * [1, 2, ...] < v_pm_smpls[-1].  If the
    first pitch mark is after t=0, row 0 is duplicated as the t=0 anchor.
    """
    v_pm = np.asarray(v_pm_smpls, np.float64)
    const_rate_smpls = fs * const_rate_ms / 1000.0
    v_grid = np.arange(const_rate_smpls, v_pm[-1], const_rate_smpls)
    m, squeeze = _rows_1d(m_data, device)
    if v_pm[0] > 0:
        x = np.r_[0.0, v_pm]
        m = torch.cat([m[:1], m])
    else:
        x = v_pm
    out = interp_linear_axis0(torch.tensor(x, dtype=m.dtype), m,
                              torch.tensor(v_grid, dtype=m.dtype),
                              device=m.device)
    return out[:, 0] if squeeze else out


def interp_from_const_to_variable_rate(m_data, v_frm_locs_smpls,
                                       frm_rate_ms: float, fs: int, *,
                                       device="cuda") -> torch.Tensor:
    """Constant grid -> variable frame locations (magphase.py:2242-2252),
    on ``device``."""
    m, squeeze = _rows_1d(m_data, device)
    frm_rate_smpls = fs * frm_rate_ms / 1000.0
    x = frm_rate_smpls * np.arange(1, m.shape[0] + 1)
    out = interp_linear_axis0(
        torch.tensor(x, dtype=m.dtype), m,
        torch.tensor(np.asarray(v_frm_locs_smpls), dtype=m.dtype),
        device=m.device)
    return out[:, 0] if squeeze else out


def const_rate_resample_batch(m_feats, f0, pm, n_frames, *,
                              const_rate_smpls: float, fc_max: int):
    """Variable -> constant rate for a batch of padded utterances, on
    their device: the batched form of analysis_compressed's const-rate
    block (magphase.py:2967-2980).  The features are linearly interpolated
    onto the grid (t=0 anchored with a duplicated first row); f0 is
    interpolated over the voiced frames only and gated by the interpolated
    voicing > 0.5.

    m_feats: tuple of (B, F, D) tensors; f0 (B, F); pm (B, F) integer
    samples; n_frames (B,) valid frame counts.  Returns (outs (B, fc_max,
    D) each, f0_const (B, fc_max), n_const (B,) int32); rows past n_const
    are zeros."""
    B, F = pm.shape
    dev = pm.device
    f32 = torch.float32
    frm = torch.arange(F, device=dev)[None, :]
    valid = frm < n_frames[:, None]
    pm_f = pm.to(f32)
    last = torch.clamp(n_frames - 1, min=0).to(torch.int64)[:, None]
    last_pm = torch.gather(pm_f, 1, last)
    big = torch.tensor(1e18, dtype=f32, device=dev)  # padding x
    zero = torch.zeros(B, 1, dtype=f32, device=dev)

    x = torch.cat([zero, torch.where(valid, pm_f, big)], dim=1)
    grid = ((torch.arange(fc_max, dtype=f32, device=dev) + 1.0)
            * const_rate_smpls).expand(B, fc_max)
    n_const = (grid < last_pm).sum(dim=1).to(torch.int32)

    outs = tuple(interp_linear_rows(x, torch.cat([m[:, :1], m], dim=1), grid)
                 for m in m_feats)

    # voiced-only f0: voiced marks sorted to the front (a stable sort, as
    # jnp.argsort), the padding tail clamped to the last voiced value so
    # the interpolation past the last voiced mark stays constant
    voi_b = valid & (f0 > 1.0)
    xv = torch.where(voi_b, pm_f, big)
    order = torch.argsort(xv, dim=1, stable=True)
    xv_s = torch.gather(xv, 1, order)
    fv_s = torch.gather(f0, 1, order)
    nv = voi_b.sum(dim=1)
    last_f0 = torch.gather(fv_s, 1, torch.clamp(nv - 1, min=0)[:, None])
    fv_s = torch.where(frm < nv[:, None], fv_s, last_f0)
    f0_i = interp_linear_rows(torch.cat([zero, xv_s], dim=1),
                              torch.cat([fv_s[:, :1], fv_s], dim=1), grid)
    voi_i = interp_linear_rows(
        x, torch.cat([voi_b[:, :1], voi_b], dim=1).to(f32), grid)
    # zero everything past n_const: the clamped interpolation otherwise
    # leaks the last voiced f0 into the padding, which the downstream
    # median filter's last window would see
    in_range = torch.arange(fc_max, device=dev)[None, :] < n_const[:, None]
    f0_const = torch.where(in_range & (nv > 0)[:, None] & (voi_i > 0.5),
                           f0_i, 0.0)
    outs = tuple(torch.where(in_range[..., None], o, 0.0) for o in outs)
    return outs, f0_const, n_const


def const_rate_resample_core(m_feats, f0, pm, n_frames, *,
                             const_rate_smpls: float, fc_max: int,
                             device="cuda"):
    """const_rate_resample_batch for one padded utterance: m_feats a tuple
    of (F, D) arrays, f0 and pm (F,), n_frames the valid frame count.
    Returns (outs, f0_const, n_const) on ``device``."""
    outs, f0c, n_const = const_rate_resample_batch(
        tuple(as_f32(m, device)[None] for m in m_feats),
        as_f32(f0, device)[None], torch.as_tensor(pm, device=device)[None],
        torch.as_tensor(n_frames, device=device).reshape(1),
        const_rate_smpls=const_rate_smpls, fc_max=fc_max)
    return tuple(o[0] for o in outs), f0c[0], n_const[0]


def get_shifts_and_frm_locs_from_const_shifts(v_shift_c_rate: np.ndarray,
                                              frm_rate_ms: float, fs: int):
    """Backward walk recovering variable-rate frame locations from a
    constant-rate shift track (magphase.py:1426-1449).  Host float64;
    sequential by construction (each step depends on the interpolated shift
    at the previous location)."""
    v_shift_c_rate = np.asarray(v_shift_c_rate, np.float64)
    n = v_shift_c_rate.shape[0]
    frm_rate_smpls = fs * frm_rate_ms / 1000.0
    v_centres = frm_rate_smpls * np.arange(1, n + 1)

    locs = []
    shifts = []
    curr = v_centres[-1]
    for _ in range(2 * n - 1):
        if curr < v_centres[0]:   # out of interpolation range -> stop
            break
        locs.append(curr)
        s = np.interp(curr, v_centres, v_shift_c_rate)
        shifts.append(s)
        curr = curr - s
    locs.reverse()
    shifts.reverse()
    return np.asarray(shifts), np.asarray(locs)


def to_constant_rate(m_data, targ_shift_ms: float, v_shift, fs: int, *,
                     device="cuda") -> torch.Tensor:
    """Older cumsum-based resampler (magphase.py:2032-2044), on
    ``device``."""
    v_in_cntr = np.cumsum(np.asarray(v_shift, np.float64))
    in_len = v_in_cntr[-1] + v_shift[-1]
    targ = targ_shift_ms / 1000.0 * fs
    v_targ = np.arange(targ, in_len, targ).astype(int)
    m = as_f32(m_data, device)
    return interp_linear_axis0(torch.tensor(v_in_cntr, dtype=m.dtype), m,
                               torch.tensor(v_targ, dtype=m.dtype),
                               device=m.device)
