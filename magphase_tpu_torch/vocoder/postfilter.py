"""Post-filters for the compressed (mel log-mag) feature stream (port of
magphase_tpu/vocoder/postfilter.py: post_filter, its dev and oldest
revisions, and post_filter_merlin).

Both act on (rows, mag_dim) float32 tensors on any device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import define_alpha
from ..core import melcep
from ..core.spectral import MAGIC, rceps


def _pf_defaults(fs: int, mag_dim: int, av_len_at_zero, av_len_at_nyq,
                 boost_at_zero, boost_at_nyq):
    """Sample-rate keyed defaults (magphase.py:2306-2340)."""
    def d(x, default):
        return default if x is None else x

    if fs == 48000:
        av_len_at_zero = d(av_len_at_zero, int(round(11.0 * (mag_dim / 60.0))))
        av_len_at_nyq = d(av_len_at_nyq, int(round(3.0 * (mag_dim / 60.0))))
        boost_at_zero = d(boost_at_zero, 1.8)
        boost_at_nyq = d(boost_at_nyq, 2.0)
    elif fs == 16000:
        av_len_at_zero = d(av_len_at_zero, int(round(9.0 * (mag_dim / 60.0))))
        av_len_at_nyq = d(av_len_at_nyq, int(round(12.0 * (mag_dim / 60.0))))
        boost_at_zero = d(boost_at_zero, 2.0)
        boost_at_nyq = d(boost_at_nyq, 1.6)
    else:
        if None in (av_len_at_zero, av_len_at_nyq, boost_at_zero, boost_at_nyq):
            raise ValueError(
                "post_filter: only tuned for 16 kHz and 48 kHz; provide "
                "av_len_at_zero/av_len_at_nyq/boost_at_zero/boost_at_nyq.")
    return av_len_at_zero, av_len_at_nyq, boost_at_zero, boost_at_nyq


@functools.lru_cache(maxsize=16)
def _avg_matrix_np(mag_dim: int, av_len_at_zero: int,
                   av_len_at_nyq: int) -> np.ndarray:
    """(mag_dim, mag_dim) matrix A with (A @ v) = the reference's
    variable-length moving average v_ave (magphase.py:2343-2360), including
    the edge pinning v_ave[:nx0]=v_ave[nx0], v_ave[nx_last:]=v_ave[nx_last]."""
    v_nx = np.arange(int(np.floor(av_len_at_zero / 2)),
                     mag_dim - int(np.floor(av_len_at_nyq / 2)))
    v_lens = np.linspace(av_len_at_zero, av_len_at_nyq, v_nx.size)
    v_lens = (2 * np.ceil(v_lens / 2) - 1).astype(int)

    A = np.zeros((mag_dim, mag_dim))
    for nxb, ln in zip(v_nx, v_lens):
        half = ln // 2
        A[nxb, nxb - half:nxb + half + 1] = 1.0 / (2 * half + 1)
    A[:v_nx[0]] = A[v_nx[0]]
    A[v_nx[-1]:] = A[v_nx[-1]]
    return A


def post_filter_tables(fs: int, mag_dim: int):
    """(A^T, v_tilt) float64 host tables of post_filter at the defaults."""
    az, an, bz, bn = _pf_defaults(fs, mag_dim, None, None, None, None)
    return _avg_matrix_np(mag_dim, az, an).T, np.linspace(bz, bn, mag_dim)


def _avg_and_tilt(m: torch.Tensor, az: int, an: int, v_tilt: np.ndarray):
    """(moving average, boost tilt) of post_filter's body as tensors on
    m's device: A @ v as one matmul, the tilt per coefficient."""
    a_t = torch.tensor(_avg_matrix_np(m.shape[-1], az, an).T, dtype=m.dtype,
                       device=m.device)
    return melcep.mm(m, a_t), torch.tensor(v_tilt, dtype=m.dtype,
                                           device=m.device)


def _pin_ends(m_enh: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The end coefficients pinned to their unfiltered values
    (magphase.py:2372-2373)."""
    m_enh[..., 0] = m[..., 0]
    m_enh[..., -1] = m[..., -1]
    return m_enh


def post_filter(m_mag_mel_log: torch.Tensor, fs: int,
                av_len_at_zero: int | None = None,
                av_len_at_nyq: int | None = None,
                boost_at_zero: float | None = None,
                boost_at_nyq: float | None = None,
                tables: tuple | None = None) -> torch.Tensor:
    """MagPhase post-filter (magphase.py:2300-2378): a variable-length
    moving average as one (mag_dim x mag_dim) matmul, a boost tilt around
    it, and the end bins pinned to their unfiltered values.

    ``tables``: (A^T, v_tilt) float32 tensors on m's device when the caller
    holds them already (SynthesisTables); otherwise built here."""
    m = m_mag_mel_log
    mag_dim = m.shape[-1]
    if tables is None:
        az, an, bz, bn = _pf_defaults(fs, mag_dim, av_len_at_zero,
                                      av_len_at_nyq, boost_at_zero,
                                      boost_at_nyq)
        tables = (torch.tensor(_avg_matrix_np(mag_dim, az, an).T,
                               dtype=m.dtype, device=m.device),
                  torch.tensor(np.linspace(bz, bn, mag_dim), dtype=m.dtype,
                               device=m.device))
    a_t, v_tilt = tables
    m_ave = melcep.mm(m, a_t)
    return _pin_ends((m - m_ave) * v_tilt + m_ave, m)


def post_filter_dev(m_mag_mel_log: torch.Tensor, fs: int,
                    av_len_at_zero: int | None = None,
                    av_len_at_nyq: int | None = None,
                    boost_at_zero: float | None = None,
                    boost_at_nyq: float | None = None):
    """Dev copy of the MagPhase post-filter (magphase.py:2382-2468):
    post_filter's defaults and body, and also the average-subtracted
    residual (the reference's debug output, ``return m_mag_mel_log_enh,
    m_mag_mel_log_norm``)."""
    m = m_mag_mel_log
    mag_dim = m.shape[-1]
    az, an, bz, bn = _pf_defaults(fs, mag_dim, av_len_at_zero, av_len_at_nyq,
                                  boost_at_zero, boost_at_nyq)
    m_ave, v_tilt = _avg_and_tilt(m, az, an, np.linspace(bz, bn, mag_dim))
    m_norm = m - m_ave
    return _pin_ends(m_norm * v_tilt + m_ave, m), m_norm


def post_filter_backup_old(m_mag_mel_log: torch.Tensor) -> torch.Tensor:
    """Oldest post-filter revision (magphase.py:2254-2297): fixed 11 -> 3
    bin average lengths (scaled by mag_dim/60) and a linspace(2, 6) boost
    tilt, with no sample-rate keying."""
    m = m_mag_mel_log
    mag_dim = m.shape[-1]
    az = int(np.round(11.0 * mag_dim / 60.0))
    an = int(np.round(3.0 * mag_dim / 60.0))
    m_ave, v_tilt = _avg_and_tilt(m, az, an, np.linspace(2.0, 6.0, mag_dim))
    return _pin_ends((m - m_ave) * v_tilt + m_ave, m)


def post_filter_merlin(m_mag_mel_log: torch.Tensor, fs: int,
                       pf_coef: float = 1.4) -> torch.Tensor:
    """Merlin cepstral post-filter (magphase.py:3375-3465), SPTK stages as
    closed-form tensor ops (see the JAX package's docstring for the stage
    map): freqt uses net alpha -alpha and output order fft_len/2 - 1."""
    m = m_mag_mel_log
    ncoeffs = m.shape[-1]
    fft_len = 4096
    minph_ord = fft_len // 2 - 1
    alpha = define_alpha(fs)

    m_mcep = rceps(m, in_type="log", out_type="compact")

    w = np.full(ncoeffs, pf_coef)
    w[:2] = 1.0
    m_mcep_w = m_mcep * torch.tensor(w, dtype=m.dtype, device=m.device)

    c_lin = melcep.freqt(m_mcep, minph_ord, -alpha)
    c_lin_w = melcep.freqt(m_mcep_w, minph_ord, -alpha)
    r0 = melcep.c2acr_r0(c_lin, fft_len)
    p_r0 = melcep.c2acr_r0(c_lin_w, fft_len)

    m_b = melcep.mc2b(m_mcep_w, alpha)
    p_b0 = torch.log(r0 / p_r0) / 2.0 + m_b[..., 0]

    m_b_pf = m_b.clone()
    m_b_pf[..., 0] = p_b0
    m_mcep_pf = melcep.b2mc(m_b_pf, alpha)

    out = melcep.mcep_to_sp_cosmat(m_mcep_pf, ncoeffs, alpha=0.0,
                                   out_type="log")
    return torch.where(torch.isnan(out), MAGIC, out)   # magphase.py:3453
