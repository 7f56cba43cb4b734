"""Mel compression of analysed streams and compressed-feature synthesis,
batched (port of magphase_tpu/vocoder/compressed.py).

Analysis: the mcep mel warp of format_for_modelling (magphase.py:2490-2544)
as float32 matmuls.  Synthesis: the v2.0 synthesis of magphase.py:825-997
from mel-compressed features:
mel-unwarp (matmuls), keyed hash-noise excitation framed pitch-
synchronously, spectral assembly of the periodic and aperiodic parts,
irfft (cuFFT on the card), anti-ringing window and PSOLA overlap-add
(kernel K2).

Synthesis noise is a stateless counter hash of (key, absolute sample
index) with explicit (B, 2) uint32 keys, bit-identical to the JAX
package's, so both packages draw the same excitation for the same keys.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import define_alpha, define_crossfade_params
from ..core import framing, melcep
from ..core.filters import butter_highpass_sos, sos_freq_response_rfft
from ..core.interp import extend_nearest_coeffs
from ..core.spectral import (build_mel_curve, build_min_phase_from_mag_spec,
                             crossfade_down_win_np, db, protected_log)
from ..core.windows import HANNING, VOI_NOISE, asym_win_value_select
from .postfilter import post_filter_tables

PER_PHASE_TYPES = ("magphase", "linear", "min_phase")


def get_num_full_mel_coeffs_from_num_phase_coeffs(freq_hz: float,
                                                  phase_dim: int,
                                                  alpha: float,
                                                  fs: int) -> int:
    """Invert the mel curve: full-band mel coefficient count such that
    ``phase_dim`` coefficients reach ``freq_hz`` (magphase.py:2479-2487)."""
    crsf_cw = 2 * np.pi * freq_hz / float(fs)
    cf_mel = np.arctan((1 - alpha ** 2) * np.sin(crsf_cw)
                       / ((1 + alpha ** 2) * np.cos(crsf_cw) - 2 * alpha))
    if cf_mel < 0:
        cf_mel += np.pi
    return int(np.round(1 + (np.pi * (phase_dim - 1) / float(cf_mel))))


def synthesis_fft_len(fft_len: int, max_framelen: int) -> int:
    """Adaptive synthesis FFT size: the smallest power of 2 that contains
    every pitch-sync frame (longest adjacent shift pair + 1), floored at
    1024 and capped at the nominal ``fft_len``."""
    n = fft_len
    while n // 2 >= 1024 and max_framelen <= n // 2:
        n //= 2
    return n


def max_pitch_sync_framelen(v_shift_i: np.ndarray) -> int:
    """Longest synthesis frame: max over f of L[f]+R[f]+1 with
    L[f]=shift[f], R[f]=shift[f+1] (R[last]=shift[last])."""
    s = np.asarray(v_shift_i, np.int64).reshape(-1)
    if s.shape[0] < 2:
        return int(2 * s.max(initial=1) + 1)
    pairs = s[:-1] + s[1:]
    return int(max(pairs.max(), 2 * s[-1]) + 1)


# ---------------------------------------------------------------------------
# analysis side: mel compression

def _format_kernel(m_mag, m_real, m_imag, v_voi, *, mag_dim: int,
                   phase_dim: int, mag_dim_ph: int, alpha: float,
                   alpha_phase: float, b_mag_fbank_mel: bool = False):
    """Mel compression of the three spectral streams, rows (n, h) ->
    (n, mag_dim) log-magnitude and (n, phase_dim) phase coefficients
    (format_for_modelling, magphase.py:2503-2542).  Only the mcep warp is
    ported: ``b_mag_fbank_mel=True`` raises ValueError."""
    if b_mag_fbank_mel:
        raise ValueError("b_mag_fbank_mel=True: the filter-bank mel warp is "
                         "not ported; only the mcep warp is")
    m_mag_mel_log = protected_log(melcep.sp_mel_warp(
        m_mag, mag_dim, alpha=alpha, in_type=3))
    voi = v_voi[:, None]
    m_real_mel = melcep.sp_mel_warp(m_real, mag_dim_ph, alpha=alpha_phase,
                                    in_type=2)[:, :phase_dim]
    m_imag_mel = melcep.sp_mel_warp(m_imag, mag_dim_ph, alpha=alpha_phase,
                                    in_type=2)[:, :phase_dim]
    m_real_mel = torch.clamp(m_real_mel * voi, -1.0, 1.0)
    m_imag_mel = torch.clamp(m_imag_mel * voi, -1.0, 1.0)
    return m_mag_mel_log, m_real_mel, m_imag_mel


def format_for_modelling(m_mag, m_real, m_imag, v_f0, fs: int,
                         mag_dim: int = 60, phase_dim: int = 45,
                         b_mag_fbank_mel: bool = False,
                         alpha_phase: float | None = None, *,
                         device="cuda"):
    """magphase.py:2490-2544: numpy lossless streams (n, h) and f0 (n,) in,
    float64 numpy (mag_mel_log, real_mel, imag_mel, lf0) out.  The median-
    smoothed lf0 is host float64 (scipy), the mel warps run on ``device``."""
    from scipy import signal as sp_signal

    alpha = define_alpha(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], phase_dim, alpha_phase, fs)
    v_voi = (np.asarray(v_f0) > 0).astype(np.float64)
    v_f0_smth = v_voi * sp_signal.medfilt(np.asarray(v_f0, np.float64))
    with np.errstate(divide="ignore"):
        v_lf0_smth = np.log(np.maximum(v_f0_smth, 0))
    v_lf0_smth[~np.isfinite(v_lf0_smth)] = -1.0e10

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    outs = _format_kernel(dev(m_mag), dev(m_real), dev(m_imag), dev(v_voi),
                          mag_dim=mag_dim, phase_dim=phase_dim,
                          mag_dim_ph=mag_dim_ph, alpha=alpha,
                          alpha_phase=alpha_phase,
                          b_mag_fbank_mel=b_mag_fbank_mel)
    return tuple(o.cpu().numpy().astype(np.float64) for o in outs) + (
        v_lf0_smth,)


# ---------------------------------------------------------------------------
# synthesis side

class SynthesisTables(torch.nn.Module):
    """The per-configuration constant tables of synthesis, as buffers that
    ``.to(device)`` moves: mel-unwarp cosine matrices, post-filter averaging
    matrix and boost tilt, crossfade gains, tilt lines, the spectral
    high-pass response and the fftshift sign vector.  Built in float32 on
    the host, so the CPU and the card compute from identical constants.

    ``mag_dim``/``mag_dim_ph``: omit to build only the tables of
    ``synthesis_core_batch`` (no unwarp matrices)."""

    def __init__(self, *, fs: int, fft_len: int, alpha: float,
                 alpha_phase: float | None = None, mag_dim: int | None = None,
                 mag_dim_ph: int | None = None, pf_type: str = "no",
                 out_hpf: str | None = None):
        super().__init__()
        h = fft_len // 2 + 1
        f32 = torch.float32

        def buf(name, value):
            if value is not None and not torch.is_tensor(value):
                value = torch.tensor(value, dtype=f32)
            self.register_buffer(name, value, persistent=False)

        # periodic/aperiodic crossfade (magphase.py:872-875, 944-952): the
        # mask is w_down per voiced frame and 0 per unvoiced frame, so its
        # square root reduces to per-bin gains selected by voicing
        crsf_cf, crsf_bw = define_crossfade_params(fs)
        w_down = torch.tensor(crossfade_down_win_np(crsf_cf, crsf_bw, fs, h),
                              dtype=f32)
        buf("per_gain", torch.where(w_down > 0.0, torch.sqrt(w_down), 0.0))
        buf("ap_gain", torch.where(w_down < 1.0, torch.sqrt(1.0 - w_down),
                                   0.0))
        # spectral tilt lines (magphase.py:915-918, 938-941)
        buf("line_unv", db(build_mel_curve(alpha, h, amp=3.5) - 3.5,
                           b_inv=True))
        buf("line_voi", db(build_mel_curve(0.6, h, amp=2.0), b_inv=True))
        # fftshift after the inverse FFT as a (-1)^k modulation
        buf("alt", 1.0 - 2.0 * (torch.arange(h) % 2).to(f32))
        if out_hpf not in (None, "spectral"):
            raise ValueError(f"out_hpf={out_hpf!r}: only 'spectral' is ported")
        hpf = (sos_freq_response_rfft(butter_highpass_sos(4, 40.0, fs),
                                      fft_len)
               if out_hpf == "spectral" else (None, None))
        buf("hpf_re", hpf[0])
        buf("hpf_im", hpf[1])
        unwarp = mag_dim is not None
        buf("cos_mag", melcep.cosmat_np(mag_dim, h, alpha) if unwarp else None)
        buf("cos_ph", melcep.cosmat_np(mag_dim_ph, h, alpha_phase)
            if unwarp else None)
        pf = post_filter_tables(fs, mag_dim) if pf_type == "magphase" \
            else (None, None)
        buf("pf_avg_t", pf[0])
        buf("pf_tilt", pf[1])


def _unwarp_kernel(m_mag_mel_log, m_real_mel, m_imag_mel, *, fft_len: int,
                   mag_dim_ph: int, alpha: float, alpha_phase: float,
                   tables: SynthesisTables | None = None):
    """Mel-unwarp of the three streams to full resolution
    (magphase.py:850-858), in float32 whatever the input dtype (float16
    features included).  Rows (..., dim) -> (..., fft_len//2+1)."""
    h = fft_len // 2 + 1
    f32 = torch.float32
    cos_mag = cos_ph = None
    if tables is not None:
        cos_mag, cos_ph = tables.cos_mag, tables.cos_ph
    m_mag = torch.exp(melcep.sp_mel_unwarp(m_mag_mel_log.to(f32), h,
                                           alpha=alpha, in_type="log",
                                           cosmat=cos_mag))
    m_real_ext = extend_nearest_coeffs(m_real_mel.to(f32), mag_dim_ph)
    m_imag_ext = extend_nearest_coeffs(m_imag_mel.to(f32), mag_dim_ph)
    m_real = melcep.sp_mel_unwarp(m_real_ext, h, alpha=alpha_phase,
                                  in_type="log", cosmat=cos_ph)
    m_imag = melcep.sp_mel_unwarp(m_imag_ext, h, alpha=alpha_phase,
                                  in_type="log", cosmat=cos_ph)
    return m_mag, m_real, m_imag


# ---------------------------------------------------------------------------
# keyed hash noise.  uint32 arithmetic is carried in int64 holding values in
# [0, 2^32): torch has no unsigned 32-bit shifts on the CPU, and a 32x32-bit
# product is formed from two 32x16-bit halves so nothing overflows int64.

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) (int64) and a constant c < 2^32."""
    lo = x * (c & 0xFFFF)
    hi = torch.bitwise_and(x * (c >> 16), 0xFFFF) << 16
    return torch.bitwise_and(lo + hi, _M32)


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finaliser: full avalanche on a uint32 lane."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_noise_at(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Stateless white noise in [-1, 1) at absolute sample indices,
    bit-identical to magphase_tpu.vocoder.compressed.hash_noise_at.

    keys (B, 2) integer tensor of uint32 values; idx (B, ...) integer
    sample positions.  Sample (b, i) depends only on (keys[b], i) — never
    on batch size, padding or layout."""
    shape = (-1,) + (1,) * (idx.ndim - 1)
    keys = keys.to(torch.int64)
    k0 = torch.bitwise_and(keys[:, 0], _M32).reshape(shape)
    k1 = torch.bitwise_and(keys[:, 1], _M32).reshape(shape)
    x = _fmix32(torch.bitwise_and(idx.to(torch.int64), _M32) ^ k0)
    x = _fmix32(x ^ k1)
    # top 24 bits -> [0, 1) at float32-exact spacing -> [-1, 1)
    return (x >> 8).to(torch.float32) * (2.0 / (1 << 24)) - 1.0


def _noise_frames_direct(keys, pm, nfrms, ns_len, fft_len: int,
                         fam_voiced: int, fam_unvoiced: int, voi, dtype):
    """Windowed pitch-sync NOISE frames computed directly in frame space:
    each element is hash(key, left_lim + q) * win(q) with exactly the frame
    geometry of framing.pitch_sync_frames_batch (q = (p + L) mod fft_len,
    index clipped to [0, ns_len-1]), so the (B, ns_len) noise buffer of the
    reference formulation (magphase.py:879-897) never exists."""
    last = (ns_len - 1)[:, None]
    pm = torch.minimum(torch.clamp(pm, min=0), last)
    left_lim, L, R, valid = framing.frame_geometry_batch(pm, nfrms, ns_len)
    p = torch.arange(fft_len, device=pm.device)
    L3 = L[..., None]
    R3 = R[..., None]
    q = torch.remainder(p + L3, fft_len)
    in_frame = (q < L3 + R3 + 1) & valid[..., None]
    idx = torch.minimum(torch.clamp(left_lim[..., None] + q, min=0),
                        last[..., None])
    vals = hash_noise_at(keys, idx).to(dtype)
    win = asym_win_value_select(q, L3, R3, voi[..., None], fam_voiced,
                                fam_unvoiced)
    return torch.where(in_frame, vals * win.to(dtype), 0.0)


def synthesis_core_batch(m_mag, m_real, m_imag, v_voi, pm, shifts, nfrms,
                         ns_len, keys, *, fs: int, fft_len: int,
                         alpha: float, b_voi_ap_win: bool,
                         per_phase_type: str, out_len_max: int,
                         out_hpf: str | None = None,
                         tables: SynthesisTables | None = None):
    """The v2.0 synthesis from full-resolution spectra (magphase.py:872-976),
    batched: (B, F, H) spectra, (B, F) voicing/pm/shifts, (B,) nfrms/ns_len,
    (B, 2) noise keys, all on one device.  pm/shifts are precomputed
    host-side in float64 (truncation semantics of magphase.py:879-880).
    Returns the un-trimmed OLA buffers (B, out_len_max).

    ``out_hpf='spectral'`` folds the 40 Hz output high-pass into the frame
    spectra as a per-bin complex gain."""
    if per_phase_type not in PER_PHASE_TYPES:
        raise ValueError(per_phase_type)
    B, F = pm.shape
    h = fft_len // 2 + 1
    dtype = m_mag.dtype
    dev = m_mag.device
    if tables is None:
        tables = SynthesisTables(fs=fs, fft_len=fft_len, alpha=alpha,
                                 out_hpf=out_hpf).to(dev)
    valid = torch.arange(F, device=dev)[None, :] < nfrms[:, None]
    v_voi = v_voi != 0
    voi = v_voi & valid
    unv = ~v_voi & valid
    voi3 = voi[..., None]

    # --- noise generation + pitch-sync windowing (877-897), directly in
    # frame space from the keyed hash
    m_frm_ns = _noise_frames_direct(
        keys, pm, nfrms, ns_len, fft_len,
        VOI_NOISE if b_voi_ap_win else HANNING, HANNING, voi, dtype)
    m_ns_cmplx = torch.fft.rfft(m_frm_ns)
    del m_frm_ns

    # --- noise gain normalisation (899-906): sqrt(exp(mean(log|NS|_mid^2)))
    log2 = protected_log(torch.abs(m_ns_cmplx[..., 1:-1])) ** 2

    def _masked_gain(mask):
        cnt = torch.clamp(mask.sum(dim=1), min=1) * (h - 2)
        s = torch.where(mask[..., None], log2, 0.0).sum(dim=(1, 2))
        return torch.sqrt(torch.exp(s / cnt))

    gain = torch.where(voi, _masked_gain(voi)[:, None],
                       torch.where(unv, _masked_gain(unv)[:, None], 1.0))
    del log2
    m_ns_cmplx = m_ns_cmplx / gain[..., None]

    # --- aperiodic spectrum (908-918)
    m_ap = m_ns_cmplx * m_mag
    del m_ns_cmplx
    m_ap = torch.where(unv[..., None], m_ap * tables.line_unv, m_ap)

    # --- periodic spectrum (920-941).  'magphase': mag * (re + j im) /
    # |re + j im| via rsqrt of the squared norm, guarded only at exactly 0
    # (the reference's guard, magphase.py:926-929): a subnormal ph2 keeps
    # its unit phasor, since nothing here flushes subnormals
    if per_phase_type == "magphase":
        ph2 = m_real * m_real + m_imag * m_imag
        scale = m_mag * torch.where(ph2 > 0.0, torch.rsqrt(ph2), 1.0)
        m_per = torch.complex(m_real * scale, m_imag * scale)
        del ph2, scale
    elif per_phase_type == "linear":
        m_per = m_mag.to(m_ap.dtype)
    else:
        m_per = build_min_phase_from_mag_spec(
            m_mag.reshape(B * F, h)).reshape(B, F, h)
    m_per = torch.where(voi3, m_per * tables.line_voi, m_per)

    # --- masks with sqrt + zero protection (944-952), as per-bin gains
    m_per = torch.where(voi3, m_per * tables.per_gain, 0.0)
    m_ap = torch.where(voi3, m_ap * tables.ap_gain, m_ap)

    # --- sum + DC/Nyquist protection (954-961)
    m_syn = m_per + m_ap
    del m_per, m_ap
    m_syn[..., 0] = torch.abs(m_syn[..., 0]).to(m_syn.dtype)
    m_syn[..., -1] = torch.abs(m_syn[..., -1]).to(m_syn.dtype)

    if out_hpf == "spectral":
        # 40 Hz output high-pass (magphase.py:990-995) as a per-bin gain
        s_re, s_im = m_syn.real, m_syn.imag
        hre, him = tables.hpf_re, tables.hpf_im
        m_syn = torch.complex(s_re * hre - s_im * him, s_re * him + s_im * hre)
    elif out_hpf is not None:
        raise ValueError(f"out_hpf={out_hpf!r}: only 'spectral' is ported")

    # --- to time domain (963-965), fftshift folded in as (-1)^k
    m_frm = torch.fft.irfft(m_syn * tables.alt, n=fft_len)
    del m_syn

    # --- anti-ringing window (968-973) + PSOLA overlap-add (976)
    m_frm = framing.apply_anti_ringing(m_frm, shifts, nfrms)
    return framing.ola_centered_batch(m_frm, pm, nfrms, out_len_max)
