"""Remaining DSP utility surface of libaudio.py / magphase.py (port of
magphase_tpu/core/misc_dsp.py).

interp_unv_regions      libaudio.py:273-291
smooth_by_conv          libaudio.py:878-918
windowing_const_rate    libaudio.py:505-533  (+ GetNFramesFromSigLen 537-543)
mcep_to_lin_sp_log      libaudio.py:548-558
cos_win                 libaudio.py:145-148
hz_to_bin / bin_to_hz   libaudio.py:151-155
next_pow_of_two         libaudio.py:495-502
ph_enc / ph_dec         magphase.py:423-441
win_squared             magphase.py:2472-2477
get_ap_mask_from_uv_decision  magphase.py:1979-1996

The tensor functions run on the device of the tensor they are given
(array inputs become CPU tensors); the window and bin helpers are host
numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    """``a`` as a tensor: a tensor stays as it is, an array becomes a CPU
    tensor with float64 narrowed to float32 (the JAX package computes
    with 64-bit types off)."""
    if torch.is_tensor(a):
        return a
    t = torch.as_tensor(np.asarray(a))
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def interp_unv_regions(m_data: torch.Tensor, v_voi,
                       interp_type: str = "linear") -> torch.Tensor:
    """Interpolate feature rows across unvoiced gaps (libaudio.py:273-291).

    'zeros' zeroes unvoiced rows; 'linear' linearly interpolates between
    surrounding voiced rows (edge regions clamp to the first/last voiced
    row, matching the reference's fill_value behaviour).
    """
    vb = _t(v_voi).to(m_data.device) > 0
    if interp_type == "zeros":
        return m_data * vb[:, None].to(m_data.dtype)

    n = m_data.shape[0]
    idx = torch.arange(n, device=m_data.device)
    # nearest voiced row at/before i, and at/after i
    prev_v = torch.cummax(torch.where(vb, idx, -1), dim=0).values
    next_v = n - 1 - torch.flip(torch.cummax(
        torch.where(torch.flip(vb, [0]), idx, -1), dim=0).values, [0])
    first = torch.argmax(vb.to(torch.int8))
    last = n - 1 - torch.argmax(torch.flip(vb, [0]).to(torch.int8))
    prev_v = torch.clamp(torch.where(prev_v < 0, first, prev_v), 0, n - 1)
    next_v = torch.clamp(torch.where(next_v > last, last, next_v), 0, n - 1)
    d_prev = m_data[prev_v]
    d_next = m_data[next_v]
    span = torch.clamp(next_v - prev_v, min=1)
    w = ((idx - prev_v) / span)[:, None].to(m_data.dtype)
    interp = d_prev + w * (d_next - d_prev)
    out = torch.where((next_v == prev_v)[:, None], d_prev, interp)
    return torch.where(vb[:, None], m_data, out)


def smooth_by_conv(m_data: torch.Tensor, v_win=None) -> torch.Tensor:
    """Boundary-extended moving-average smoother along axis 0
    (libaudio.py:878-918)."""
    if v_win is None:
        v_win = np.hanning(11)
    v_win = np.asarray(v_win, np.float64)
    win_len = len(v_win)
    if win_len < 3:
        return m_data
    if win_len % 2 == 0:
        # the reference's extension arithmetic only works for odd windows
        # (libaudio.py:880)
        raise ValueError("smooth_by_conv window length must be odd")
    half = (win_len - 1) // 2
    # np.convolve flips the kernel (true convolution); the sum below is a
    # correlation, so flip here to match libaudio.py:901
    k = torch.tensor((v_win / v_win.sum())[::-1].copy(), dtype=m_data.dtype,
                     device=m_data.device)
    one_d = m_data.ndim == 1
    if one_d:
        m_data = m_data[:, None]
    ext = torch.cat([m_data[:1].expand(half, -1), m_data,
                     m_data[-1:].expand(half, -1)], dim=0)
    n = m_data.shape[0]
    idx = torch.arange(n, device=m_data.device)[:, None] + \
        torch.arange(win_len, device=m_data.device)[None, :]
    out = torch.einsum("nwd,w->nd", ext[idx], k)
    return out[:, 0] if one_d else out


def windowing_const_rate(v_sig: torch.Tensor, winlen: int, shift: int,
                         winfunc=np.hanning, extend: str = "none"):
    """Constant frame-rate windowing (libaudio.py:505-533)."""
    shift = int(shift)
    v_win = torch.tensor(winfunc(winlen), dtype=v_sig.dtype,
                         device=v_sig.device)
    if extend in ("both", "beg"):
        v_sig = torch.cat([v_sig.new_zeros(winlen // 2), v_sig])
    if extend in ("both", "end"):
        v_sig = torch.cat([v_sig, v_sig.new_zeros(winlen)])
    n_frms = int(np.floor(1 + (v_sig.shape[0] - winlen) / float(shift)))
    idx = (torch.arange(n_frms, device=v_sig.device) * shift)[:, None] + \
        torch.arange(winlen, device=v_sig.device)[None, :]
    return v_sig[idx] * v_win


def get_n_frames_from_sig_len(sig_len: int, shift_ms: float, fs: int) -> int:
    """libaudio.py:537-543."""
    shift = round(fs * shift_ms / 1000)
    return int(np.ceil(1 + ((sig_len - 1) / shift)))


def mcep_to_lin_sp_log(m_mgc: torch.Tensor, nFFT: int) -> torch.Tensor:
    """mcep -> log spectrum without warping (libaudio.py:548-558)."""
    n_frms, n_coeffs = m_mgc.shape
    half = nFFT // 2 + 1
    m = torch.cat([m_mgc, m_mgc.new_zeros(n_frms, nFFT // 2 - n_coeffs + 1)],
                  dim=1)
    m = torch.cat([m, torch.flip(m[:, 1:-1], [1])], dim=1)
    return torch.fft.fft(m, n=nFFT).real[:, :half]


def cos_win(N: int) -> np.ndarray:
    """sin half-wave window; cos_win**2 == hanning (libaudio.py:145-148)."""
    return np.sin(np.linspace(0, np.pi, N))


def hz_to_bin(v_hz, nFFT: int, fs: int):
    return np.asarray(v_hz) * nFFT / float(fs)


def bin_to_hz(v_bin, nFFT: int, fs: int):
    return np.asarray(v_bin) * fs / float(nFFT)


def next_pow_of_two(x) -> int:
    x = max(x, 2)
    return int(2 ** np.ceil(np.log2(x)))


def ph_enc(m_ph: torch.Tensor):
    """phase -> (sin, cos) (magphase.py:423-426)."""
    return torch.sin(m_ph), torch.cos(m_ph)


def ph_dec(m_phs: torch.Tensor, m_phc: torch.Tensor, mode: str = "angle"):
    """(sin, cos) -> phase (magphase.py:431-441)."""
    if mode == "sign":
        return torch.sign(torch.arcsin(m_phs)) * torch.abs(
            torch.arccos(m_phc))
    if mode == "angle":
        return torch.atan2(m_phs, m_phc)
    raise ValueError(mode)


def win_squared(L: int) -> np.ndarray:
    """Centre-half boxcar (magphase.py:2472-2477)."""
    v = np.zeros(L)
    q, h = int(np.floor(L / 4.0)), int(np.floor(L / 2.0))
    v[q:q + h] = 1.0
    return v


def _faded_mask(v_ap: torch.Tensor, nFFT: int, fs: int, mvf: float,
                fade_len: int) -> torch.Tensor:
    """The per-frame value v_ap below the maximum voiced frequency, faded
    to 1 over its last fade_len bins, and 1 above it."""
    mvf_bin = int(np.round(mvf * nFFT / float(fs)))
    m = 1.0 - v_ap[:, None].expand(-1, mvf_bin)
    ramp = torch.tensor(np.linspace(1, 0, fade_len), dtype=m.dtype,
                        device=m.device)
    m = torch.cat([m[:, :mvf_bin - fade_len], m[:, mvf_bin - fade_len:]
                   * ramp], dim=1)
    m = 1.0 - m
    half = nFFT // 2 + 1
    return torch.cat([m, m.new_ones(v_ap.shape[0], half - mvf_bin)], dim=1)


def get_ap_mask_from_uv_decision(v_voi, nFFT: int, fs: int, mvf: float,
                                 fade_len: int = 40) -> torch.Tensor:
    """Legacy aperiodicity mask (magphase.py:1979-1996)."""
    v_voi = _t(v_voi)
    v_ap = 1.0 - torch.clamp(v_voi, 0, 1).to(torch.float32)
    return _faded_mask(v_ap, nFFT, fs, mvf, fade_len)


def estim_ap_mask_from_ph_data(m_mask_ref, nFFT: int, fs: int, mvf: float):
    """Legacy aperiodicity mask estimated from phase-feature RMS
    (magphase.py:2000-2027): per-frame dB RMS clipped to [-28.1, -10.3],
    normalised, faded over 40 bins below the maximum voiced frequency."""
    clip_lo, clip_hi = -28.1, -10.3
    m_ref = _t(m_mask_ref)
    v_db = 20.0 * torch.log10(torch.sqrt(torch.mean(m_ref ** 2, dim=1)))
    v_ap = -torch.clamp(v_db, clip_lo, clip_hi)
    v_ap = (v_ap + clip_hi) / float(clip_hi - clip_lo)
    return _faded_mask(v_ap, nFFT, fs, mvf, 40)


def gen_mask_simple(v_voi, nbins: int, cutoff_bin: int) -> torch.Tensor:
    """1=deterministic, 0=stochastic (libaudio.py:39-45)."""
    m = _t(v_voi)[:, None].repeat(1, nbins)
    m[:, cutoff_bin:] = 0
    return m


def mix_by_mask(m_data_a, m_data_b, m_mask):
    """mask-weighted mix: 1 -> a, 0 -> b (libaudio.py:49-57)."""
    m_mask = _t(m_mask)
    return m_mask * _t(m_data_a) + (1 - m_mask) * _t(m_data_b)


def frame_shift(v_frm, shift: int, out_len: int) -> np.ndarray:
    """Place a frame at offset ``shift`` in a zero buffer
    (libaudio.py:137-140)."""
    v_frm = np.asarray(v_frm)
    out = np.zeros(out_len, v_frm.dtype)
    out[shift:shift + len(v_frm)] = v_frm
    return out
