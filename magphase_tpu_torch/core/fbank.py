"""Filter-bank mel warp family (port of magphase_tpu/core/fbank.py).

References: apply_fbank (libaudio.py:721-761), sp_mel_warp_fbank (763-769),
sp_mel_unwarp_fbank (815-845), unwarp_from_fbank (848-874).  The filter
bank and the unwarp interpolation are fixed matrices per (alpha, bins,
bands), built on the host in float64 (scipy, imported at first use) and
applied as float32 matmuls through ``melcep.mm``, which refuses TF32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .interp import as_f32
from .melcep import mm
from .spectral import mel_curve_np, protected_log
from .windows import gen_non_symmetric_win_np


def _band_centres(v_bins_warp: np.ndarray, nbins: int, nbands: int,
                  kind: str) -> np.ndarray:
    """Linear-bin centres of ``nbands`` bands equally spaced on the warped
    axis."""
    from scipy import interpolate
    v_cntrs_mel = np.linspace(0, v_bins_warp[-1], nbands)
    f_interp = interpolate.interp1d(v_bins_warp, np.arange(nbins), kind=kind)
    return np.round(f_interp(v_cntrs_mel)).astype(int)


def _fbank_from_centres(v_cntrs: np.ndarray, nbins: int,
                        nbands: int) -> np.ndarray:
    """(nbins, nbands) normalised asymmetric hanning bands between
    neighbouring centres (apply_fbank 'average' mode)."""
    m_fbank = np.zeros((nbins, nbands))
    v_ext = np.r_[v_cntrs[0], v_cntrs, v_cntrs[-1]]
    for nxb in range(1, nbands + 1):
        wl = v_ext[nxb] - v_ext[nxb - 1]
        wr = v_ext[nxb + 1] - v_ext[nxb]
        v_win = gen_non_symmetric_win_np(wl, wr, np.hanning, b_norm=True)
        m_fbank[v_ext[nxb - 1]:v_ext[nxb - 1] + len(v_win), nxb - 1] = v_win
    return m_fbank


def _interp_from_centres(v_cntrs: np.ndarray, nbins: int, nbands: int,
                         kind: str) -> np.ndarray:
    """(nbands, nbins) matrix of the per-frame interpolation from band
    centres to linear bins (a fixed linear map)."""
    from scipy import interpolate
    M = np.zeros((nbands, nbins))
    for b in range(nbands):
        e = np.zeros(nbands)
        e[b] = 1.0
        M[b] = interpolate.interp1d(v_cntrs, e, kind=kind)(np.arange(nbins))
    return M


@functools.lru_cache(maxsize=16)
def _fbank_matrix_np(alpha: float, nbins: int, nbands: int) -> np.ndarray:
    """Averaging filter bank on the warped grid (apply_fbank 'average'
    mode, libaudio.py:721-753)."""
    v_cntrs = _band_centres(mel_curve_np(alpha, nbins), nbins, nbands,
                            "quadratic")
    return _fbank_from_centres(v_cntrs, nbins, nbands)


@functools.lru_cache(maxsize=16)
def _unwarp_interp_matrix_np(alpha: float, nbins: int, nbands: int,
                             kind: str = "quadratic") -> np.ndarray:
    """(nbands, nbins) interpolation matrix of unwarp_from_fbank
    (libaudio.py:848-874)."""
    v_cntrs = _band_centres(mel_curve_np(alpha, nbins), nbins, nbands, kind)
    return _interp_from_centres(v_cntrs, nbins, nbands, kind)


@functools.lru_cache(maxsize=16)
def _unwarp_curve_matrix_np(alpha: float, nbins_total: int, max_bin: int,
                            nbands: int, kind: str = "quadratic") -> np.ndarray:
    """Interpolation matrix over a truncated warp curve
    (phase_uncompress_fbank, magphase.py:798-808: the curve is
    build_mel_curve(alpha, fft_len_half)[:max_bin])."""
    v_cntrs = _band_centres(mel_curve_np(alpha, nbins_total)[:max_bin],
                            max_bin, nbands, kind)
    return _interp_from_centres(v_cntrs, max_bin, nbands, kind)


@functools.lru_cache(maxsize=16)
def _fbank_curve_matrix_np(alpha: float, nbins_total: int, max_bin: int,
                           nbands: int) -> np.ndarray:
    """Filter bank over a truncated warp curve
    (format_for_modelling_phase_comp, magphase.py:2588-2593)."""
    v_cntrs = _band_centres(mel_curve_np(alpha, nbins_total)[:max_bin],
                            max_bin, nbands, "quadratic")
    return _fbank_from_centres(v_cntrs, max_bin, nbands)


@functools.lru_cache(maxsize=32)
def _matrix(builder, args: tuple, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """The matrix ``builder(*args)`` on ``device``, uploaded once."""
    return torch.tensor(builder(*args), dtype=dtype, device=device)


def _apply(m: torch.Tensor, builder, *args) -> torch.Tensor:
    return mm(m, _matrix(builder, args, m.device, m.dtype))


def apply_fbank(m_mag, alpha: float, nbands: int, *,
                device="cuda") -> torch.Tensor:
    m = as_f32(m_mag, device)
    return _apply(m, _fbank_matrix_np, alpha, m.shape[1], nbands)


def sp_mel_warp_fbank(m_mag, n_melbands: int, alpha: float = 0.77, *,
                      device="cuda") -> torch.Tensor:
    """libaudio.py:763-769: exp(fbank(log|X|))."""
    return torch.exp(apply_fbank(protected_log(as_f32(m_mag, device)), alpha,
                                 n_melbands, device=device))


def _td_spans_2d(n_melbands: int, max_span: int = 5) -> np.ndarray:
    """Per-band temporal smoothing spans (libaudio.py:798-801): the warp
    curve at alpha=-0.3 scaled to [1, max_span], forced odd."""
    v = 1.0 + mel_curve_np(-0.3, n_melbands, amp=float(max_span - 1.0))
    return (2 * np.ceil(v / 2.0) - 1).astype(int)


def _smooth_by_conv(m_data: torch.Tensor, v_win: np.ndarray) -> torch.Tensor:
    """Edge-extended moving average along axis 0 with an odd window
    (misc_dsp.smooth_by_conv of the JAX package, libaudio.py:878-918)."""
    v_win = np.asarray(v_win, np.float64)
    win_len = len(v_win)
    if win_len < 3:
        return m_data
    half = (win_len - 1) // 2
    # np.convolve flips the kernel; the gather below correlates
    k = torch.tensor((v_win / v_win.sum())[::-1].copy(), dtype=m_data.dtype,
                     device=m_data.device)
    ext = torch.cat([m_data[:1].expand(half, -1), m_data,
                     m_data[-1:].expand(half, -1)])
    n = m_data.shape[0]
    idx = (torch.arange(n, device=m_data.device)[:, None]
           + torch.arange(win_len, device=m_data.device)[None, :])
    return torch.einsum("nwd,w->nd", ext[idx], k)


def sp_mel_warp_fbank_2d(m_mag, n_melbands: int, alpha: float = 0.77,
                         max_span: int = 5, *, device="cuda") -> torch.Tensor:
    """libaudio.py:771-813: the filter-bank warp, then each band's log
    trajectory smoothed along the frames with hanning(span + 2), the span
    growing with the band index."""
    m_log = apply_fbank(protected_log(as_f32(m_mag, device)), alpha,
                        n_melbands, device=device)
    spans = _td_spans_2d(n_melbands, max_span)
    out = m_log.clone()
    for span in np.unique(spans):
        sel = torch.as_tensor(np.where(spans == span)[0], device=out.device)
        out[:, sel] = _smooth_by_conv(m_log[:, sel],
                                      np.hanning(int(span) + 2))
    return torch.exp(out)


def unwarp_from_fbank(m_mag_mel, alpha: float, nbins: int,
                      interp_kind: str = "quadratic", *,
                      device="cuda") -> torch.Tensor:
    """libaudio.py:848-874 as a matmul."""
    m = as_f32(m_mag_mel, device)
    return _apply(m, _unwarp_interp_matrix_np, alpha, nbins, m.shape[1],
                  interp_kind)


def sp_mel_unwarp_fbank(m_mag_mel, nbins: int, alpha: float = 0.77, *,
                        device="cuda") -> torch.Tensor:
    """libaudio.py:815-845."""
    return unwarp_from_fbank(m_mag_mel, alpha, nbins, device=device)


def unwarp_from_fbank_curve(m_mel, alpha: float, nbins_total: int,
                            max_bin: int, kind: str = "quadratic", *,
                            device="cuda") -> torch.Tensor:
    m = as_f32(m_mel, device)
    return _apply(m, _unwarp_curve_matrix_np, alpha, nbins_total, max_bin,
                  m.shape[1], kind)


def apply_fbank_curve(m_data, alpha: float, nbins_total: int, max_bin: int,
                      nbands: int, *, device="cuda") -> torch.Tensor:
    """apply_fbank ('average' mode) over the first ``max_bin`` bins of the
    full warp curve; columns beyond max_bin are ignored."""
    m = as_f32(m_data, device)
    return _apply(m[:, :max_bin], _fbank_curve_matrix_np, alpha, nbins_total,
                  max_bin, nbands)
