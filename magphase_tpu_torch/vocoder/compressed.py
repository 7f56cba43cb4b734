"""Compressed (low-dimensional) analysis and synthesis — the acoustic-model
feature path (port of magphase_tpu/vocoder/compressed.py).

Analysis: the mel warp of format_for_modelling (magphase.py:2490-2544),
mcep or filter bank, as float32 matmuls; analysis_compressed
(magphase.py:2947-2988) over the lossless analysis, with the optional
constant 5 ms frame rate.  Synthesis: the v2.0 synthesis of
magphase.py:825-997 from mel-compressed features: mel-unwarp (matmuls),
keyed hash-noise excitation framed pitch-synchronously, spectral assembly
of the periodic and aperiodic parts, irfft (cuFFT on the card),
anti-ringing window and PSOLA overlap-add (kernel K2);
synthesis_from_compressed is the single-utterance entry, and the 40 Hz
output high-pass there is the host float64 IIR.

Synthesis noise is a stateless counter hash of (key, absolute sample
index) with explicit (B, 2) uint32 keys, bit-identical to the JAX
package's, so both packages draw the same excitation for the same keys.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import define_alpha, define_crossfade_params, define_fft_len
from ..core import fbank, framing, melcep
from ..core.filters import (butter_highpass_coeffs, butter_highpass_sos,
                            sos_freq_response_rfft, sosfilt)
from ..core.interp import as_f32, extend_nearest_coeffs
from ..core.spectral import (build_mel_curve, build_min_phase_from_mag_spec,
                             crossfade_down_win_np, db, protected_log,
                             rows_fft)
from ..core.windows import HANNING, VOI_NOISE, asym_win_value_select
from ..io import wav as wav_io
from ..io.featfile import read_binfile, write_featfile
from ..utils.keys import prng_key
from ..utils.padding import (FRM_STEP, bucket, bucket_signal, pad_rows,
                             pad_to)
from . import framerate, lossless
from .postfilter import post_filter, post_filter_merlin, post_filter_tables

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
    (format_for_modelling, magphase.py:2503-2542); ``b_mag_fbank_mel``
    warps the magnitude with the filter bank (magphase.py:2504-2505)
    instead of the mcep warp."""
    if b_mag_fbank_mel:
        m_mag_mel = fbank.sp_mel_warp_fbank(m_mag, mag_dim, alpha=alpha,
                                            device=m_mag.device)
    else:
        m_mag_mel = melcep.sp_mel_warp(m_mag, mag_dim, alpha=alpha,
                                       in_type=3)
    m_mag_mel_log = protected_log(m_mag_mel)
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
    """magphase.py:2490-2544: lossless streams (n, h) (numpy, or tensors)
    and numpy f0 (n,) in, float64 numpy (mag_mel_log, real_mel, imag_mel,
    lf0) out.  The median-smoothed lf0 is host float64 (scipy), the mel
    warps run on ``device``."""
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
        return as_f32(a, device).to(torch.float32)

    outs = _format_kernel(dev(m_mag), dev(m_real), dev(m_imag), dev(v_voi),
                          mag_dim=mag_dim, phase_dim=phase_dim,
                          mag_dim_ph=mag_dim_ph, alpha=alpha,
                          alpha_phase=alpha_phase,
                          b_mag_fbank_mel=b_mag_fbank_mel)
    return tuple(o.cpu().numpy().astype(np.float64) for o in outs) + (
        v_lf0_smth,)


def analysis_compressed(wav_file: str, fft_len: int | None = None,
                        mag_dim: int = 60, phase_dim: int = 10,
                        b_const_rate: bool = False,
                        b_mag_fbank_mel: bool = False,
                        alpha_phase: float | None = None,
                        est_file: str | None = None,
                        pm_sec=None, voi=None, *, device="cuda"):
    """magphase.py:2947-2988: the lossless analysis of one wav, optionally
    resampled to the constant 5 ms frame rate, then mel-compressed.
    Returns (mag_mel_log, real_mel, imag_mel, lf0, shift, fs, fft_len);
    with ``b_const_rate`` the streams are on the 5 ms grid and shift stays
    the variable-rate track.

    ``b_mag_fbank_mel``: compress mag with the filter-bank warp.  The
    reference accepts the flag (magphase.py:2948) but drops it
    (format_for_modelling is called without it at 2985); it is forwarded
    here, as the JAX package does."""
    m_mag, m_real, m_imag, v_f0, fs, v_shift = lossless.analysis_lossless(
        wav_file, fft_len=fft_len, est_file=est_file, pm_sec=pm_sec, voi=voi,
        device=device)

    if b_const_rate:
        # the voiced-only f0 interpolation (magphase.py:2976-2980) indexes
        # the first voiced frame: an all-unvoiced utterance raises
        # IndexError, as in the reference
        if not np.any(np.asarray(v_f0) > 1.0):
            raise IndexError("analysis_compressed(b_const_rate=True): no "
                             "voiced frame to interpolate f0 from")
        v_pm = np.cumsum(v_shift)
        crs = fs * 5.0 / 1000.0
        streams, f0_c, n_const = framerate.const_rate_resample_core(
            (m_mag, m_real, m_imag), v_f0, v_pm, len(v_pm),
            const_rate_smpls=crs, fc_max=int(np.ceil(v_pm[-1] / crs)),
            device=device)
        n_const = int(n_const)
        m_mag, m_real, m_imag = (m[:n_const] for m in streams)
        v_f0 = f0_c[:n_const].cpu().numpy()

    m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0 = format_for_modelling(
        m_mag, m_real, m_imag, v_f0, fs, mag_dim=mag_dim,
        phase_dim=phase_dim, b_mag_fbank_mel=b_mag_fbank_mel,
        alpha_phase=alpha_phase, device=device)
    fft_len = 2 * (m_mag.shape[1] - 1)
    return m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, v_shift, fs, fft_len


def analysis_for_acoustic_modelling(wav_file: str, out_dir: str,
                                    fft_len: int | None = None,
                                    mag_dim: int = 60, phase_dim: int = 10,
                                    b_const_rate: bool = False, *,
                                    device="cuda", **kw) -> None:
    """magphase.py:2992-3022: analysis_compressed written to
    <file id>.{mag,real,imag,lf0[,shift]} in ``out_dir`` (without the
    reference's ``alpha_phase=b_mag_fbank_mel`` argument slip at 3010)."""
    (m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, v_shift, fs,
     fft_len) = analysis_compressed(wav_file, fft_len=fft_len,
                                    mag_dim=mag_dim, phase_dim=phase_dim,
                                    b_const_rate=b_const_rate, device=device,
                                    **kw)
    file_id = os.path.basename(wav_file).split(".")[0]
    write_featfile(m_mag_mel_log, out_dir, file_id + ".mag")
    write_featfile(m_real_mel, out_dir, file_id + ".real")
    write_featfile(m_imag_mel, out_dir, file_id + ".imag")
    write_featfile(v_lf0, out_dir, file_id + ".lf0")
    if not b_const_rate:
        write_featfile(v_shift, out_dir, file_id + ".shift")


# ---------------------------------------------------------------------------
# synthesis side

OUT_HPF_MODES = (None, "spectral", "blocked")


def check_out_hpf(out_hpf) -> None:
    if out_hpf not in OUT_HPF_MODES:
        raise ValueError(f"out_hpf={out_hpf!r}: expected one of "
                         f"{OUT_HPF_MODES}")


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
        check_out_hpf(out_hpf)
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


def phase_uncompress_type1_mcep(m_real_mel, m_imag_mel, alpha: float,
                                fft_len: int, fs: int, *, device="cuda"):
    """magphase.py:1219-1235: nearest-extend the phase_dim coefficients to
    mag_dim_for_phase_comp, then mel-unwarp, on ``device``."""
    m_real_mel = as_f32(m_real_mel, device)
    m_imag_mel = as_f32(m_imag_mel, device)
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], m_real_mel.shape[1], alpha, fs)
    h = 1 + fft_len // 2
    return tuple(melcep.sp_mel_unwarp(extend_nearest_coeffs(m, mag_dim_ph),
                                      h, alpha=alpha, in_type="log")
                 for m in (m_real_mel, m_imag_mel))


def _unwarp_kernel(m_mag_mel_log, m_real_mel, m_imag_mel, *, fft_len: int,
                   mag_dim_ph: int, alpha: float, alpha_phase: float,
                   b_fbank_mel: bool = False,
                   tables: SynthesisTables | None = None):
    """Mel-unwarp of the three streams to full resolution
    (magphase.py:850-858), in float32 whatever the input dtype (float16
    features included).  Rows (..., dim) -> (..., fft_len//2+1).
    ``b_fbank_mel`` unwarps mag through the filter bank
    (magphase.py:851-852) instead of the mcep cosine matrix."""
    h = fft_len // 2 + 1
    f32 = torch.float32
    cos_mag = cos_ph = None
    if tables is not None:
        cos_mag, cos_ph = tables.cos_mag, tables.cos_ph
    if b_fbank_mel:
        m_mag = torch.exp(fbank.sp_mel_unwarp_fbank(
            m_mag_mel_log.to(f32), h, alpha=alpha,
            device=m_mag_mel_log.device))
    else:
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


def _keys_tensor(keys, device) -> torch.Tensor:
    """uint32 key words as an int64 tensor on ``device`` (torch has no
    uint32 arithmetic on the CPU)."""
    if torch.is_tensor(keys):
        return keys.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64)).to(
        device)


def hash_noise_uniform(keys, n: int, *, device="cuda") -> torch.Tensor:
    """(B, 2) uint32 keys -> (B, n) float32 white noise in [-1, 1)."""
    return hash_noise_at(_keys_tensor(keys, device),
                         torch.arange(n, device=device)[None, :])


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


# the noise gain's fixed point: terms in steps of 2^-20, each below 2^14 (a
# finite float32 has |log| < 104, so log^2 < 1.1e4); up to 2^26 terms of an
# utterance sum below 2^60 in int64
_GAIN_FIX = float(1 << 20)
_GAIN_TERM_MAX = float(1 << 14)


def synthesis_core_batch(m_mag, m_real, m_imag, v_voi, pm, shifts, nfrms,
                         ns_len, keys, *, fs: int, fft_len: int,
                         alpha: float, b_voi_ap_win: bool,
                         per_phase_type: str, out_len_max: int,
                         ns_len_max: int | None = None,
                         out_hpf: str | None = None,
                         tables: SynthesisTables | None = None):
    """The v2.0 synthesis from full-resolution spectra (magphase.py:872-976),
    batched: (B, F, H) spectra, (B, F) voicing/pm/shifts, (B,) nfrms/ns_len,
    (B, 2) noise keys, all on one device.  pm/shifts are precomputed
    host-side in float64 (truncation semantics of magphase.py:879-880).
    Returns the un-trimmed OLA buffers (B, out_len_max).

    ``ns_len_max``, the noise buffer's bucket in the JAX package's
    signature, changes nothing: the noise is drawn directly in frame space
    as a function of the absolute sample index, so no buffer exists.

    ``out_hpf``: the 40 Hz output high-pass, 'spectral' folded into the
    frame spectra as a per-bin complex gain, or 'blocked' as sosfilt's
    fixed-section FFT convolution of each utterance's overlap-added buffer
    (JAX parallel/batch.py:84-96; output sample i depends only on the
    buffer's samples up to i, so not on the batch's padded length)."""
    if per_phase_type not in PER_PHASE_TYPES:
        raise ValueError(per_phase_type)
    check_out_hpf(out_hpf)
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
    m_ns_cmplx = rows_fft(torch.fft.rfft, m_frm_ns)
    del m_frm_ns

    # --- noise gain normalisation (899-906): sqrt(exp(mean(log|NS|_mid^2)))
    log2 = protected_log(torch.abs(m_ns_cmplx[..., 1:-1])) ** 2

    def _masked_gain(mask):
        """The mean over an utterance's masked frames as an exact sum of
        fixed-point terms: a float sum's order follows the batch's shape on
        the card, and with it the gain's last bits (and so PCM16 samples);
        an integer sum has no order.  A term of _GAIN_TERM_MAX or more can
        only be MAGIC^2 (the log of a zero bin), whose float sum gives an
        infinite gain: kept as such."""
        cnt = torch.clamp(mask.sum(dim=1), min=1) * (h - 2)
        terms = torch.where(mask[..., None], log2, 0.0)
        q = torch.round(torch.clamp(terms, max=_GAIN_TERM_MAX) * _GAIN_FIX)
        s = (q.to(torch.int64).sum(dim=(1, 2)).to(torch.float64)
             / _GAIN_FIX).to(dtype)
        gain = torch.sqrt(torch.exp(s / cnt))
        return torch.where(terms.amax(dim=(1, 2)) >= _GAIN_TERM_MAX,
                           torch.inf, gain)

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

    # --- to time domain (963-965), fftshift folded in as (-1)^k
    m_frm = rows_fft(torch.fft.irfft, m_syn * tables.alt, n=fft_len)
    del m_syn

    # --- anti-ringing window (968-973) + PSOLA overlap-add (976)
    m_frm = framing.apply_anti_ringing(m_frm, shifts, nfrms)
    bufs = framing.ola_centered_batch(m_frm, pm, nfrms, out_len_max)
    if out_hpf == "blocked":
        bufs = sosfilt(butter_highpass_sos(4, 40.0, fs), bufs, mode="blocked")
    return bufs


def synthesis_core(m_mag, m_real, m_imag, v_voi, pm, shifts, nfrms,
                   ns_len, key, *, device="cuda", **kw) -> torch.Tensor:
    """synthesis_core_batch for one utterance on ``device``: (F, H)
    spectra, (F,) voicing/pm/shifts, scalar nfrms/ns_len, a (2,) key;
    ``kw`` are synthesis_core_batch's keywords.  Returns (out_len_max,)."""
    one = [torch.as_tensor(a, device=device)[None]
           for a in (m_mag, m_real, m_imag, v_voi, pm, shifts)]
    counts = [torch.as_tensor(a, device=device).reshape(1)
              for a in (nfrms, ns_len)]
    keys = _keys_tensor(key, device).reshape(1, 2)
    return synthesis_core_batch(*one, *counts, keys, **kw)[0]


def synthesis_from_compressed(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0,
                              fs: int, fft_len: int | None = None,
                              b_voi_ap_win: bool = True,
                              b_fbank_mel: bool = False,
                              b_const_rate: bool = False,
                              per_phase_type: str = "magphase",
                              alpha_phase: float | None = None,
                              b_out_hpf: bool = True,
                              key=None, *, device="cuda") -> np.ndarray:
    """Primary v2.0 synthesis entry (magphase.py:825-997): one utterance's
    compressed features (numpy) -> float64 waveform.

    ``b_fbank_mel``: mag was compressed with the filter-bank warp
    (analysis_compressed's ``b_mag_fbank_mel``).  ``b_const_rate``: the
    features are on the constant 5 ms grid.  ``key``: the (2,) uint32
    noise key, used as given (``utils.keys.prng_key(0)`` when None).
    ``b_out_hpf``: the 40 Hz output high-pass as the reference's host
    float64 IIR.  The unwarp, the synthesis core and the overlap-add
    (kernel K2) run on ``device``."""
    from scipy import signal as sp_signal

    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    if key is None:
        key = prng_key(0)
    device = torch.device(device)

    m_mag_mel_log = np.asarray(m_mag_mel_log, np.float64)
    m_real_mel = np.atleast_2d(np.asarray(m_real_mel, np.float64))
    m_imag_mel = np.atleast_2d(np.asarray(m_imag_mel, np.float64))
    v_lf0 = np.asarray(v_lf0, np.float64)

    # f0 / voicing / shifts, host float64 (magphase.py:845-848)
    v_f0 = np.exp(v_lf0)
    v_voi = v_f0 > 1.0
    v_shift = framerate.f0_to_shift_np(v_f0, fs)
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], m_real_mel.shape[1], alpha_phase, fs)

    # the const->variable shift walk is host math, done before the unwarp
    # so that the adaptive synthesis FFT sees the realised shifts (the
    # spectra are interpolated after the unwarp)
    const_rate_ms = 5.0
    if b_const_rate:
        v_shift, v_frm_locs = \
            framerate.get_shifts_and_frm_locs_from_const_shifts(
                v_shift, const_rate_ms, fs)
    fft_syn = synthesis_fft_len(
        fft_len, max_pitch_sync_framelen(framerate.truncate_shifts(v_shift)))

    # mel-unwarp (850-858) of the features rounded to float16, as the
    # batched path uploads them: the two entries then compute from the
    # same inputs
    n_in = m_mag_mel_log.shape[0]
    Fin = bucket(n_in, FRM_STEP)

    def f16(a):
        return torch.from_numpy(pad_to(a.astype(np.float16), Fin)).to(device)

    m_mag, m_real, m_imag = (x[:n_in] for x in _unwarp_kernel(
        f16(m_mag_mel_log), f16(m_real_mel), f16(m_imag_mel),
        fft_len=fft_syn, mag_dim_ph=mag_dim_ph, alpha=alpha,
        alpha_phase=alpha_phase, b_fbank_mel=b_fbank_mel))

    # constant -> variable frame rate on the unwarped spectra (861-870)
    if b_const_rate:
        def variable(m):
            return framerate.interp_from_const_to_variable_rate(
                m, v_frm_locs, const_rate_ms, fs, device=device)

        m_mag, m_real, m_imag = variable(m_mag), variable(m_real), \
            variable(m_imag)
        v_voi = variable(v_voi.astype(np.float64)).cpu().numpy() > 0.5

    nfrms = int(v_shift.shape[0])
    v_shift_i = framerate.truncate_shifts(v_shift)   # truncation (879)
    v_pm = np.cumsum(v_shift_i)                      # shift_to_pm (880)
    ns_len = int(v_pm[-1] + (v_pm[-1] - v_pm[-2]))
    out_len = int(v_pm[-1] + (v_pm[-1] - v_pm[-2]) + 1)
    F = bucket(nfrms, FRM_STEP)

    def rows(a, np_dtype):
        return torch.from_numpy(pad_to(a.astype(np_dtype), F)).to(device)

    buf = synthesis_core(
        pad_rows(m_mag, F), pad_rows(m_real, F), pad_rows(m_imag, F),
        rows(v_voi, np.float32), rows(v_pm, np.int32),
        rows(v_shift_i, np.int32), nfrms, ns_len, key, device=device, fs=fs,
        fft_len=fft_syn, alpha=alpha, b_voi_ap_win=b_voi_ap_win,
        per_phase_type=per_phase_type, out_len_max=bucket_signal(out_len),
        ns_len_max=bucket_signal(ns_len))
    v_syn = buf[:out_len].cpu().numpy().astype(np.float64)

    if b_out_hpf:
        # 4th-order Butterworth high-pass at 40 Hz (magphase.py:990-995),
        # host float64: its poles sit so close to the unit circle that a
        # float32 recursion is unstable
        b, a = butter_highpass_coeffs(4, 40.0, fs)
        v_syn = sp_signal.lfilter(np.asarray(b), np.asarray(a), v_syn)
    return v_syn


def synthesis_from_acoustic_modelling(in_feats_dir: str, filename_token: str,
                                      out_syn_dir: str, mag_dim: int,
                                      phase_dim: int, fs: int,
                                      fft_len: int | None = None,
                                      pf_type: str = "no",
                                      b_const_rate: bool = False,
                                      key=None, *, device="cuda") -> None:
    """File-level synthesis entry (magphase.py:3229-3275): reads
    <token>.{mag,real,imag,lf0} from ``in_feats_dir``, applies the
    post-filter of ``pf_type`` ('no', 'magphase' or 'merlin') on
    ``device``, and writes <token>.wav to ``out_syn_dir``."""
    def feat(ext, dim):
        return read_binfile(os.path.join(in_feats_dir, filename_token + ext),
                            dim=dim)

    m_mag_mel_log = feat(".mag", mag_dim)
    m_real_mel = feat(".real", phase_dim)
    m_imag_mel = feat(".imag", phase_dim)
    v_lf0 = feat(".lf0", 1)
    m_mag_mel_log = post_filtered(m_mag_mel_log, fs, pf_type, device=device)
    v_syn = synthesis_from_compressed(m_mag_mel_log, m_real_mel, m_imag_mel,
                                      v_lf0, fs, fft_len=fft_len,
                                      b_const_rate=b_const_rate, key=key,
                                      device=device)
    wav_io.write_audio_file(
        os.path.join(out_syn_dir, filename_token + ".wav"), v_syn, fs)


def post_filtered(m_mag_mel_log, fs: int, pf_type: str, *, device="cuda"):
    """numpy mel log-magnitudes through the post-filter of ``pf_type``
    ('no', 'magphase' or 'merlin'), computed in float32 on ``device`` (the
    JAX package's float32) -> numpy."""
    if pf_type == "no":
        return m_mag_mel_log
    if pf_type not in ("magphase", "merlin"):
        raise ValueError(pf_type)
    m = torch.from_numpy(np.asarray(m_mag_mel_log, np.float32)).to(device)
    pf = post_filter if pf_type == "magphase" else post_filter_merlin
    return pf(m, fs).cpu().numpy()
