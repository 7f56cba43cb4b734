"""Filter-bank phase-compression pipeline (port of
magphase_tpu/vocoder/phase_comp.py, the reference's experimental
"phase_comp" family; the reference notes it "didn't work very well",
magphase.py:3028).

  format_for_modelling_phase_comp              magphase.py:2547-2640
  analysis_compressed_type1_with_phase_comp    magphase.py:3024-3092
  synthesis_from_compressed_type1_with_phase_comp  magphase.py:1000-1215

The per-frame interp1d loops of the reference's fbank warp are fixed
(bins x bands) matrices applied as one matmul (core/fbank.py); the noise
synthesis is the type1 core of vocoder/variants.py with the anti-ringing
window applied before the overlap-add (kernel K2), the two-pass form the
JAX package uses.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import define_alpha, define_crossfade_params, define_fft_len
from ..core import fbank, melcep
from ..core.filters import butter_highpass_coeffs
from ..core.interp import as_f32
from ..core.spectral import protected_log
from ..io.featfile import write_featfile
from ..utils.keys import prng_key
from ..utils.padding import FRM_STEP, bucket
from . import framerate
from .variants import (_legacy_noise_synthesis, _to_variable_rate,
                       phase_uncompress_fbank)


def format_for_modelling_phase_comp(m_mag, m_real, m_imag, v_f0, fs: int,
                                    mag_dim: int = 60, phase_dim: int = 10,
                                    b_mag_fbank_mel: bool = False, *,
                                    device="cuda"):
    """magphase.py:2547-2593: mag mel-warp (mcep or fbank) + phase
    compression by a filter bank over the warp curve truncated at the
    crossfade bin, on ``device``.  Unlike format_for_modelling, the phase
    streams are NOT voicing-zeroed or clipped (2592-2593).  Returns float64
    numpy (mag_mel_log, real_mel, imag_mel, lf0)."""
    from scipy import signal as sp_signal
    alpha = define_alpha(fs)

    # f0 -> smoothed lf0 (2558-2560), host float64
    v_voi = (np.asarray(v_f0) > 0).astype(np.float64)
    v_f0_smth = v_voi * sp_signal.medfilt(np.asarray(v_f0, np.float64))
    with np.errstate(divide="ignore"):
        v_lf0_smth = np.log(np.maximum(v_f0_smth, 0))
    v_lf0_smth[~np.isfinite(v_lf0_smth)] = -1.0e10

    nfrms, h = tuple(m_mag.shape)
    fft_len = 2 * (h - 1)
    crsf_cf, _ = define_crossfade_params(fs)
    bin_cf = int(np.round(crsf_cf * fft_len / float(fs)))   # hz_to_bin

    F = bucket(nfrms, FRM_STEP)

    def dev(m):
        m = as_f32(m, device).to(torch.float32)
        return torch.cat([m, m.new_zeros(F - nfrms, h)])

    mag_d, real_d, imag_d = dev(m_mag), dev(m_real), dev(m_imag)
    if b_mag_fbank_mel:
        m_mag_mel = fbank.sp_mel_warp_fbank(mag_d, mag_dim, alpha=alpha,
                                            device=device)
    else:
        m_mag_mel = melcep.sp_mel_warp(mag_d, mag_dim, alpha=alpha,
                                       in_type=3)
    outs = (protected_log(m_mag_mel),
            fbank.apply_fbank_curve(real_d, alpha, h, bin_cf, phase_dim,
                                    device=device),
            fbank.apply_fbank_curve(imag_d, alpha, h, bin_cf, phase_dim,
                                    device=device))
    return tuple(o[:nfrms].cpu().numpy().astype(np.float64)
                 for o in outs) + (v_lf0_smth,)


def analysis_compressed_type1_with_phase_comp(
        wav_file: str, fft_len: int | None = None,
        out_dir: str | None = None, mag_dim: int = 60, phase_dim: int = 10,
        b_const_rate: bool = False, b_mag_fbank_mel: bool = False, *,
        device="cuda", **kw):
    """magphase.py:3024-3092: lossless analysis (epochs from ``kw``'s
    pm_sec/voi, est_file, or the tracker), optionally on the constant 5 ms
    grid, then format_for_modelling_phase_comp.  With ``out_dir`` the
    streams go to files there and None is returned; else (mag_mel_log,
    real_mel, imag_mel, lf0, shift, fs, fft_len)."""
    from .lossless import analysis_lossless
    m_mag, m_real, m_imag, v_f0, fs, v_shift = analysis_lossless(
        wav_file, fft_len=fft_len, device=device, **kw)

    if b_const_rate:   # 3040-3052
        v_pm_smpls = np.cumsum(v_shift)

        def const(m):
            return framerate.interp_from_variable_to_const_frm_rate(
                m, v_pm_smpls, 5.0, fs, device=device)

        m_mag, m_real, m_imag = const(m_mag), const(m_real), const(m_imag)
        v_f0, _ = _interp_f0_const_rate(v_f0, v_pm_smpls, 5.0, fs,
                                        device=device)

    mml, mrm, mim, v_lf0 = format_for_modelling_phase_comp(
        m_mag, m_real, m_imag, v_f0, fs, mag_dim=mag_dim,
        phase_dim=phase_dim, b_mag_fbank_mel=b_mag_fbank_mel, device=device)

    fft_len = 2 * (m_mag.shape[1] - 1)
    if isinstance(out_dir, str):   # 3082-3090
        file_id = os.path.basename(wav_file).split(".")[0]
        write_featfile(mml, out_dir, file_id + ".mag")
        write_featfile(mrm, out_dir, file_id + ".real")
        write_featfile(mim, out_dir, file_id + ".imag")
        write_featfile(v_lf0, out_dir, file_id + ".lf0")
        if not b_const_rate:
            write_featfile(v_shift, out_dir, file_id + ".shift")
        return None
    return mml, mrm, mim, v_lf0, v_shift, fs, fft_len


def _interp_f0_const_rate(v_f0, v_pm_smpls, const_rate_ms, fs, *,
                          device="cuda"):
    """The voiced-only f0 resampling shared by the const-rate analysis
    entries (magphase.py:3049-3052 == 2974-2979 == 3138-3141): f0 of the
    voiced frames, anchored at both ends, and the voicing, each on the
    constant grid.  Returns float numpy (f0 * voicing, voicing)."""
    v_voi = v_f0 > 1.0

    def const(m, pm):
        return framerate.interp_from_variable_to_const_frm_rate(
            m, pm, const_rate_ms, fs, device=device).cpu().numpy().squeeze()

    v_f0_c = const(np.r_[v_f0[v_voi][0], v_f0[v_voi], v_f0[v_voi][-1]],
                   np.r_[0, v_pm_smpls[v_voi], v_pm_smpls[-1]])
    v_voi_c = const(v_voi.astype(np.float64), v_pm_smpls) > 0.5
    return v_f0_c * v_voi_c, v_voi_c


def synthesis_from_compressed_type1_with_phase_comp(
        m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, fs: int,
        fft_len: int | None = None, b_voi_ap_win: bool = True,
        b_fbank_mel: bool = False, const_rate_ms: float = -1.0,
        per_phase_type: str = "magphase", key=None, *,
        device="cuda") -> np.ndarray:
    """magphase.py:1000-1215: mag unwarp (mcep or fbank), fbank phase
    uncompression, type1 noise synthesis WITH the anti-ringing window
    (1168-1173), Butterworth 40 Hz high-pass on the host (1205-1210).
    ``key``: the (2,) uint32 noise key (prng_key(0) when None)."""
    from scipy import signal as sp_signal
    if key is None:
        key = prng_key(0)
    device = torch.device(device)
    crsf_cf, crsf_bw = define_crossfade_params(fs)
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    h = fft_len // 2 + 1

    m_mag_mel_log = np.asarray(m_mag_mel_log, np.float64)
    m_real_mel = np.atleast_2d(np.asarray(m_real_mel, np.float64))
    m_imag_mel = np.atleast_2d(np.asarray(m_imag_mel, np.float64))
    v_f0 = np.exp(np.asarray(v_lf0, np.float64))
    v_voi = v_f0 > 1.0
    v_shift = framerate.f0_to_shift_np(v_f0, fs)

    mml_d = as_f32(m_mag_mel_log, device)
    if b_fbank_mel:   # 1029-1032
        m_mag = torch.exp(fbank.sp_mel_unwarp_fbank(mml_d, h, alpha=alpha,
                                                    device=device))
    else:
        m_mag = torch.exp(melcep.sp_mel_unwarp(mml_d, h, alpha=alpha,
                                               in_type="log"))
    streams = (m_mag,) + phase_uncompress_fbank(
        m_real_mel.astype(np.float32), m_imag_mel.astype(np.float32),
        crsf_cf, crsf_bw, alpha, fft_len, fs, device=device)

    if const_rate_ms > 0:   # 1043-1051
        streams, v_voi, v_shift = _to_variable_rate(
            streams, v_voi.astype(np.float64), v_shift, const_rate_ms, fs,
            device)

    v_syn = _legacy_noise_synthesis(
        *streams, v_voi, v_shift, fs, fft_len, alpha, b_voi_ap_win,
        per_phase_type, key, anti_ringing=True, device=device)

    # Butterworth 40 Hz HPF (1205-1210)
    b, a = butter_highpass_coeffs(4, 40.0, fs)
    return sp_signal.lfilter(np.asarray(b), np.asarray(a), v_syn)
