"""Float64 host-precision lossless path (port of
magphase_tpu/vocoder/lossless_f64.py, which is numpy: this is its own
copy, bitwise equal to it).

The pitch-synchronous analysis / resynthesis math of the reference
(magphase.py:266-334, 457-476, 1759-1776) in float64 numpy on the host,
formulated densely (vectorised window matrices + an ordered scatter-add)
rather than as the reference's ragged per-frame loops, yet element for
element equivalent.  Use it where archival exactness matters more than
throughput; the float32 device path (vocoder/lossless.py) is the
production one.
"""
from __future__ import annotations

import numpy as np

from ..config import MagPhaseConfig

__all__ = ["analysis_lossless_f64", "synthesis_from_lossless_f64",
           "copy_synthesis_f64"]


def _asym_window_matrix(L: np.ndarray, R: np.ndarray, T: int) -> np.ndarray:
    """(F, T) dense matrix of the reference's asymmetric pitch-sync
    windows: frame f carries hanning-left of half-length L[f] and
    hanning-right of half-length R[f] on support t in [0, L+R]
    (gen_non_symmetric_win, libaudio.py:70-84).

    Elementwise formula matches np.hanning(M)[q] = 0.5 + 0.5*cos(pi*
    (2q - (M-1))/(M-1)) exactly, so values are bit-identical to the
    per-frame construction (np.cos is even, so the mirrored right half
    evaluates to the same doubles)."""
    t = np.arange(T, dtype=np.float64)[None, :]
    Lc = L[:, None].astype(np.float64)
    Rc = R[:, None].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        left = 0.5 + 0.5 * np.cos(np.pi * (2.0 * t - 2.0 * Lc) / (2.0 * Lc))
        right = 0.5 + 0.5 * np.cos(np.pi * (2.0 * (t - Lc)) / (2.0 * Rc))
    w = np.where(t <= Lc, np.where(Lc == 0, 1.0, left), right)
    w = np.where((t > Lc) & (Rc == 0), 0.0, w)      # unreachable guard
    return np.where(t <= Lc + Rc, w, 0.0)


def analysis_lossless_f64(v_sig: np.ndarray, fs: int, pm_sec: np.ndarray,
                          voi: np.ndarray, fft_len: int | None = None):
    """Float64 pitch-sync analysis with epochs given
    (analysis_with_del_comp_from_pm + compute_lossless_feats,
    magphase.py:266-334 + 457-476).

    Returns (m_mag, m_real, m_imag, v_f0, v_shift), float64/int."""
    if fft_len is None:
        fft_len = MagPhaseConfig(fs=fs).fft_len
    v_sig = np.asarray(v_sig, np.float64)
    n = v_sig.shape[0]
    pm = np.round(np.asarray(pm_sec, np.float64) * fs).astype(np.int64)
    pm_plus = np.concatenate(([0], pm, [n - 1]))
    F = pm.shape[0]
    L = pm_plus[1:-1] - pm_plus[:-2]          # left half-lengths = shifts
    R = pm_plus[2:] - pm_plus[1:-1]

    # dense windowed frames, zero-padded/truncated to fft_len
    # (magphase.py:309-315), then circular delay compensation: rotate
    # left by L[f] so the window centre sits at sample 0 (:317-323)
    T = fft_len
    j = np.arange(T)[None, :]
    src = (j + L[:, None]) % T                 # post-roll gather index
    sample_pos = pm_plus[:-2, None] + src
    vals = v_sig[np.clip(sample_pos, 0, n - 1)]
    w = _asym_window_matrix(L, R, T)
    frames = np.where(src <= (L + R)[:, None], vals * _gather_rows(w, src),
                      0.0)

    m_fft = np.fft.fft(frames)[:, :fft_len // 2 + 1]

    # compute_lossless_feats (magphase.py:457-476)
    m_mag = np.absolute(m_fft)
    m_div = np.where(m_mag == 0.0, 1.0, m_mag)
    m_real = np.where(m_mag == 0.0, 0.0, m_fft.real / m_div)
    m_imag = np.where(m_mag == 0.0, 0.0, m_fft.imag / m_div)
    v_shift = L.astype(np.int64)
    v_f0 = np.asarray(voi, np.float64) * fs / v_shift.astype(np.float64)
    return m_mag, m_real, m_imag, v_f0, v_shift


def _gather_rows(w: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return np.take_along_axis(w, idx, axis=1)


def synthesis_from_lossless_f64(m_mag, m_real, m_imag, v_f0,
                                fs: int) -> np.ndarray:
    """Float64 deterministic resynthesis (synthesis_from_lossless,
    magphase.py:1759-1776: phasor -> hermitian -> ifft -> fftshift ->
    pitch-sync OLA with the reference's boundary trims)."""
    m_mag = np.asarray(m_mag, np.float64)
    m_real = np.asarray(m_real, np.float64)
    m_imag = np.asarray(m_imag, np.float64)
    v_f0 = np.asarray(v_f0, np.float64)

    m_ph = m_real + 1j * m_imag
    ph_mag = np.absolute(m_ph)
    ph_mag = np.where(ph_mag == 0.0, 1.0, ph_mag)
    m_fft = m_mag * m_ph / ph_mag

    # add_hermitian_half 'complex' (libaudio.py:369-388): even-mirrored
    # real, odd-mirrored imag with DC/Nyquist imag zeroed
    re = np.hstack((m_fft.real, np.fliplr(m_fft.real[:, 1:-1])))
    im_h = m_fft.imag.copy()
    im_h[:, 0] = 0.0
    im_h[:, -1] = 0.0
    im = np.hstack((im_h, -np.fliplr(im_h[:, 1:-1])))
    m_frm = np.fft.ifft(re + 1j * im).real
    m_frm = np.fft.fftshift(m_frm, axes=1)

    # f0_to_shift (magphase.py:2210-2215) + ola (:34-62).  The reference
    # truncates the CUMULATIVE float pitch marks to int (ola's
    # v_pm.astype(int)); reproduced literally here — exactness versus the
    # reference definition is this module's contract (the f32 production
    # path guards the same truncation with framerate.truncate_shifts).
    v_f0 = v_f0.copy()
    v_f0[v_f0 == 0] = 200.0
    v_shift_f = fs / v_f0
    v_pm = np.cumsum(v_shift_f).astype(np.int64)
    nfrms, frmlen = m_frm.shape
    v_shift = np.diff(np.concatenate(([0], v_pm)))
    starts = v_pm - v_pm[0]                    # frame f lands at strt_f

    out = np.zeros(v_pm[-1] + frmlen, np.float64)
    # ordered scatter-add == the reference's sequential loop: np.add.at
    # accumulates in row-major index order, so overlapping samples sum in
    # identical frame order (bit-exact associativity)
    idx = starts[:, None] + np.arange(frmlen)[None, :]
    np.add.at(out, idx, m_frm)
    out = out[(frmlen // 2 - v_pm[0]):]
    return out[:(v_pm[-1] + v_shift[-1] + 1)]


def copy_synthesis_f64(v_sig: np.ndarray, fs: int, pm_sec: np.ndarray,
                       voi: np.ndarray,
                       fft_len: int | None = None) -> np.ndarray:
    """Float64 lossless analysis -> resynthesis round trip (the
    demo_copy_synthesis_lossless.py:70-78 pipeline at reference
    precision)."""
    m_mag, m_real, m_imag, v_f0, _ = analysis_lossless_f64(
        v_sig, fs, pm_sec, voi, fft_len=fft_len)
    return synthesis_from_lossless_f64(m_mag, m_real, m_imag, v_f0, fs)
