"""Legacy/variant pipelines (port of magphase_tpu/vocoder/variants.py):
type1 and type2 synthesis, the old AP-mask synthesis with Griffin-Lim,
type1/type2 analysis, fbank phase uncompression.

These are the reference's earlier revisions of the compressed vocoder:
  synthesis_from_compressed_type1   magphase.py:1253-1421
  synthesis_from_compressed_type2   magphase.py:1452-1606
  synthesis_from_compressed_type1_old_with_griffin_lim  magphase.py:617-794
  analysis_compressed_type1         magphase.py:2908-2942
  analysis_lossless_type2           magphase.py:2793-2866
  analysis_compressed_type2         magphase.py:3123-3196
  phase_uncompress_type1            magphase.py:1238-1250
  phase_uncompress_fbank            magphase.py:798-820

Each synthesis runs one utterance on ``device`` as a batch of one: the
noise (``utils.keys.uniform_tensor`` of the key, bit for bit the JAX
package's ``jax.random.uniform`` draw) is windowed by kernel K1, the
voiced frames with the VOI_NOISE family and the unvoiced ones with
HANNING, and the frames are overlap-added by kernel K2.  The 60 Hz
elliptic high-pass stays a host scipy float64 lfilter, as in the JAX
package.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import define_alpha, define_crossfade_params, define_fft_len
from ..core import fbank, framing, melcep
from ..core.filters import ellip_highpass_coeffs
from ..core.interp import as_f32, extend_nearest_coeffs
from ..core.spectral import (build_mel_curve, build_min_phase_from_mag_spec,
                             crossfade_down_win_np, db, protected_log,
                             protected_log_np, true_envelope)
from ..core.windows import HANNING, VOI_NOISE
from ..utils.keys import prng_key, split, uniform_tensor
from ..utils.padding import (FRM_STEP, bucket, bucket_signal, pad_rows,
                             pad_to)
from . import framerate, lossless


def phase_uncompress_type1(m_real_mel, m_imag_mel, alpha: float,
                           fft_len: int, ncoeffs_mag: int, *,
                           device="cuda"):
    """magphase.py:1238-1250: nearest-extend to ncoeffs_mag, then unwarp,
    on ``device``."""
    h = 1 + fft_len // 2
    return tuple(melcep.sp_mel_unwarp(
        extend_nearest_coeffs(as_f32(m, device), ncoeffs_mag), h,
        alpha=alpha, in_type="log") for m in (m_real_mel, m_imag_mel))


def phase_uncompress_fbank(m_real_mel, m_imag_mel, crsf_cf: float,
                           crsf_bw: float, alpha: float, fft_len: int,
                           fs: int, *, device="cuda"):
    """magphase.py:798-820: fbank unwarp up to the crossfade bin, constant
    extension to Nyquist, on ``device``."""
    h = 1 + fft_len // 2
    bin_cf = int(np.round(crsf_cf * fft_len / float(fs)))
    out = []
    for m in (m_real_mel, m_imag_mel):
        shrt = fbank.unwarp_from_fbank_curve(m, alpha, h, bin_cf,
                                             device=device)
        out.append(torch.cat([shrt, shrt[:, -1:].expand(-1, h - bin_cf)],
                             dim=1))
    return tuple(out)


def _prep_common(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, fs,
                 fft_len):
    """Shared host-side setup of the legacy synthesis variants."""
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    m_mag_mel_log = np.asarray(m_mag_mel_log, np.float64)
    m_real_mel = np.atleast_2d(np.asarray(m_real_mel, np.float64))
    m_imag_mel = np.atleast_2d(np.asarray(m_imag_mel, np.float64))
    v_f0 = np.exp(np.asarray(v_lf0, np.float64))
    v_voi = v_f0 > 1.0
    v_shift = framerate.f0_to_shift_np(v_f0, fs)
    return (alpha, fft_len, m_mag_mel_log, m_real_mel, m_imag_mel, v_f0,
            v_voi, v_shift)


def _unwarp_streams(m_mag_mel_log, m_real_mel, m_imag_mel, *, fft_len,
                    alpha, b_fbank_mel=False, device):
    """Full-resolution (mag, real, imag) of the legacy entries on
    ``device``: mag by the mcep (or fbank) unwarp, the phase streams by
    phase_uncompress_type1."""
    h = fft_len // 2 + 1
    mml = as_f32(m_mag_mel_log, device)
    if b_fbank_mel:
        m_mag = torch.exp(fbank.sp_mel_unwarp_fbank(mml, h, alpha=alpha,
                                                    device=device))
    else:
        m_mag = torch.exp(melcep.sp_mel_unwarp(mml, h, alpha=alpha,
                                               in_type="log"))
    m_real, m_imag = phase_uncompress_type1(
        m_real_mel.astype(np.float32), m_imag_mel.astype(np.float32), alpha,
        fft_len, m_mag_mel_log.shape[1], device=device)
    return m_mag, m_real, m_imag


def _to_variable_rate(streams, v_voi, v_shift, const_rate_ms, fs, device):
    """Constant -> variable frame rate (magphase.py:1043-1051): the
    backward shift walk on the host, the streams and the voicing
    interpolated to its frame locations on ``device``."""
    v_shift, v_locs = framerate.get_shifts_and_frm_locs_from_const_shifts(
        v_shift, const_rate_ms, fs)

    def variable(m):
        return framerate.interp_from_const_to_variable_rate(
            m, v_locs, const_rate_ms, fs, device=device)

    v_voi = variable(np.asarray(v_voi, np.float64)).cpu().numpy() > 0.5
    return [variable(m) for m in streams], v_voi, v_shift


def _geometry(v_shift):
    """(nfrms, integer shifts, marks, ns_len) of a float shift track."""
    v_shift_i = framerate.truncate_shifts(v_shift)
    v_pm = np.cumsum(v_shift_i)
    return len(v_shift), v_shift_i, v_pm, int(v_pm[-1] + (v_pm[-1] -
                                                          v_pm[-2]))


def _rows_on(device, F, *arrays):
    """Host arrays padded to F rows, on ``device`` (float as float32)."""
    return [torch.from_numpy(pad_to(np.asarray(
        a, np.float32 if np.asarray(a).dtype.kind in "fb" else np.int32),
        F)).to(device) for a in arrays]


def _hpf_ellip(v_syn: np.ndarray, fs: int) -> np.ndarray:
    """The reference's 60 Hz elliptic high-pass (magphase.py:1415-1419),
    host float64."""
    from scipy import signal as sp_signal
    b, a = ellip_highpass_coeffs(4, 0.5, 80.0, 60.0, fs)
    return sp_signal.lfilter(np.asarray(b), np.asarray(a), v_syn)


def synthesis_from_compressed_type1(m_mag_mel_log, m_real_mel, m_imag_mel,
                                    v_lf0, fs: int, fft_len: int | None = None,
                                    b_voi_ap_win: bool = True,
                                    b_const_rate: bool = False,
                                    per_phase_type: str = "magphase",
                                    key=None, *, device="cuda") -> np.ndarray:
    """magphase.py:1253-1421: like the live path but the phase extends to
    ncoeffs_mag, no anti-ringing window, and an unconditional elliptic
    60 Hz high-pass.  ``key``: the (2,) uint32 noise key (prng_key(0)
    when None)."""
    if key is None:
        key = prng_key(0)
    device = torch.device(device)
    (alpha, fft_len, m_mag_mel_log, m_real_mel, m_imag_mel, v_f0, v_voi,
     v_shift) = _prep_common(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0,
                             fs, fft_len)
    streams = _unwarp_streams(m_mag_mel_log, m_real_mel, m_imag_mel,
                              fft_len=fft_len, alpha=alpha, device=device)
    if b_const_rate:
        streams, v_voi, v_shift = _to_variable_rate(
            streams, v_voi.astype(np.float64), v_shift, 5.0, fs, device)
    v_syn = _legacy_noise_synthesis(
        *streams, v_voi, v_shift, fs, fft_len, alpha, b_voi_ap_win,
        per_phase_type, key, anti_ringing=False, device=device)
    return _hpf_ellip(v_syn, fs)


def synthesis_from_compressed_type2(m_mag_mel_log, m_real_mel, m_imag_mel,
                                    v_lf0, fs: int, fft_len: int | None = None,
                                    hf_slope_coeff: float = 1.0,
                                    b_voi_ap_win: bool = True,
                                    const_rate_ms: float = -1.0,
                                    key=None, *, device="cuda") -> np.ndarray:
    """magphase.py:1452-1606: det/ap masks built from mag with an RMS
    noise gain and HF slope enhancement; anti-ringing; elliptic 60 Hz
    high-pass."""
    if key is None:
        key = prng_key(0)
    device = torch.device(device)
    (alpha, fft_len, m_mag_mel_log, m_real_mel, m_imag_mel, v_f0, v_voi,
     v_shift) = _prep_common(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0,
                             fs, fft_len)
    streams = _unwarp_streams(m_mag_mel_log, m_real_mel, m_imag_mel,
                              fft_len=fft_len, alpha=alpha, device=device)
    if const_rate_ms > 0:
        streams, v_voi, v_shift = _to_variable_rate(
            streams, (v_f0 > 0).astype(np.float64), v_shift, const_rate_ms,
            fs, device)

    nfrms, v_shift_i, v_pm, ns_len = _geometry(v_shift)
    F = bucket(nfrms, FRM_STEP)
    voi_p, pm_p, shifts_p = _rows_on(device, F, v_voi.astype(np.float32),
                                     v_pm, v_shift_i)
    buf = _type2_core(*(pad_rows(m, F) for m in streams), voi_p, pm_p,
                      shifts_p, nfrms, ns_len, key, fs=fs, fft_len=fft_len,
                      hf_slope_coeff=hf_slope_coeff,
                      b_voi_ap_win=b_voi_ap_win,
                      out_len_max=bucket_signal(ns_len + 1),
                      ns_len_max=bucket_signal(ns_len))
    return _hpf_ellip(buf[:ns_len + 1].cpu().numpy().astype(np.float64), fs)


def _legacy_noise_synthesis(m_mag, m_real, m_imag, v_voi, v_shift, fs,
                            fft_len, alpha, b_voi_ap_win, per_phase_type,
                            key, anti_ringing: bool, *, device):
    """Shared body of the type1 pipeline (magphase.py:1311-1412): padding
    to the frame bucket, the core on ``device``, the output cut to its
    length (float64 numpy)."""
    nfrms, v_shift_i, v_pm, ns_len = _geometry(v_shift)
    F = bucket(nfrms, FRM_STEP)
    voi_p, pm_p, shifts_p = _rows_on(device, F,
                                     np.asarray(v_voi, np.float32), v_pm,
                                     v_shift_i)
    buf = _type1_core(pad_rows(m_mag, F), pad_rows(m_real, F),
                      pad_rows(m_imag, F), voi_p, pm_p, shifts_p, nfrms,
                      ns_len, key, fs=fs, fft_len=fft_len, alpha=alpha,
                      b_voi_ap_win=b_voi_ap_win,
                      per_phase_type=per_phase_type,
                      out_len_max=bucket_signal(ns_len + 1),
                      ns_len_max=bucket_signal(ns_len),
                      anti_ringing=anti_ringing)
    return buf[:ns_len + 1].cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# cores: one utterance on its device, (F, h) spectra and (F,) per-frame
# rows padded to the frame bucket F, nfrms/ns_len Python ints

def _frame_masks(v_voi: torch.Tensor, nfrms: int):
    """(valid, voiced, unvoiced) (F,) boolean rows."""
    valid = torch.arange(v_voi.shape[0], device=v_voi.device) < nfrms
    vb = v_voi != 0
    return valid, vb & valid, ~vb & valid


def _crossfade(fs: int, h: int, like: torch.Tensor) -> torch.Tensor:
    """The crossfade's fade-out window w_down (spectral.crossfade_down_win_np)
    at the reference's crossfade for fs."""
    crsf_cf, crsf_bw = define_crossfade_params(fs)
    return torch.tensor(crossfade_down_win_np(crsf_cf, crsf_bw, fs, h),
                        dtype=like.dtype, device=like.device)


def noise_spectra(key, pm: torch.Tensor, voi: torch.Tensor, nfrms: int,
                  ns_len: int, *, fft_len: int, ns_len_max: int,
                  b_voi_ap_win: bool) -> torch.Tensor:
    """rfft of the pitch-synchronous noise frames (magphase.py:1311-1331):
    uniform noise in [-1, 1) drawn from ``key`` over ns_len_max samples
    (the JAX package's shape), windowed by kernel K1 with VOI_NOISE (or
    HANNING without ``b_voi_ap_win``) on the voiced frames ``voi`` and
    HANNING on the others.  Returns (F, fft_len//2+1) complex."""
    dev = pm.device
    v_ns = uniform_tensor(key, (ns_len_max,), -1.0, 1.0, device=dev)
    frames = framing.pitch_sync_frames_batch(
        v_ns[None], pm[None], torch.tensor([nfrms], device=dev),
        torch.tensor([ns_len], device=dev), fft_len,
        win_family=VOI_NOISE if b_voi_ap_win else HANNING,
        voiced=voi[None], win_family_unvoiced=HANNING)[0][0]
    return torch.fft.rfft(frames)


def _unit_phasor_times(m_mag, m_real, m_imag) -> torch.Tensor:
    """m_mag * (real + j imag) / |real + j imag|, |.| guarded at exactly 0
    (magphase.py:1365-1369)."""
    m_ph = torch.complex(m_real, m_imag)
    m_ph_mag = torch.abs(m_ph)
    return m_mag * m_ph / torch.where(m_ph_mag == 0.0, 1.0, m_ph_mag)


def _real_ends(m_syn: torch.Tensor) -> torch.Tensor:
    """The imaginary parts of DC and Nyquist zeroed (the hermitian half's
    'complex' mirror, magphase.py:1405)."""
    m_syn = m_syn.clone()
    m_syn[..., 0] = m_syn[..., 0].real.to(m_syn.dtype)
    m_syn[..., -1] = m_syn[..., -1].real.to(m_syn.dtype)
    return m_syn


def _centred_frames(m_syn: torch.Tensor, fft_len: int) -> torch.Tensor:
    """irfft of the half spectra, fftshifted: the pitch mark at
    fft_len//2."""
    return torch.roll(torch.fft.irfft(_real_ends(m_syn), n=fft_len),
                      fft_len // 2, dims=-1)


def _ola_one(m_frm, pm, nfrms: int, out_len_max: int) -> torch.Tensor:
    """Centred overlap-add of one utterance's frames (kernel K2)."""
    return framing.ola_centered_batch(
        m_frm[None], pm[None], torch.tensor([nfrms], device=pm.device),
        out_len_max)[0]


def _type1_core(m_mag, m_real, m_imag, v_voi, pm, shifts, nfrms: int,
                ns_len: int, key, *, fs: int, fft_len: int, alpha: float,
                b_voi_ap_win: bool, per_phase_type: str, out_len_max: int,
                ns_len_max: int, anti_ringing: bool = False) -> torch.Tensor:
    """magphase.py:1311-1412 for one utterance: noise spectra normalised
    by the voiced and the unvoiced log-RMS gains, the aperiodic and
    periodic spectra with their tilt lines, the crossfade masks, and the
    overlap-add (with the anti-ringing window for the phase-comp
    variant, magphase.py:1168-1173).  Returns the (out_len_max,) buffer."""
    h = fft_len // 2 + 1
    _, voi, unv = _frame_masks(v_voi, nfrms)
    w_down = _crossfade(fs, h, m_mag)
    m_mask = torch.where(voi[:, None], w_down, 0.0)

    m_ns = noise_spectra(key, pm, voi, nfrms, ns_len, fft_len=fft_len,
                         ns_len_max=ns_len_max, b_voi_ap_win=b_voi_ap_win)
    log2 = protected_log(torch.abs(m_ns)[:, 1:-1]) ** 2

    def gain(mask):
        cnt = torch.clamp(mask.sum(), min=1) * (h - 2)
        return torch.sqrt(torch.exp(
            torch.where(mask[:, None], log2, 0.0).sum() / cnt))

    one = torch.ones((), dtype=m_mag.dtype, device=m_mag.device)
    m_ns = m_ns / torch.where(voi, gain(voi),
                              torch.where(unv, gain(unv), one))[:, None]

    m_ap = m_ns * m_mag
    line_unv = db(build_mel_curve(alpha, h, amp=3.5, device=m_mag.device)
                  - 3.5, b_inv=True)
    m_ap = torch.where(unv[:, None], m_ap * line_unv, m_ap)

    if per_phase_type == "magphase":
        m_per = _unit_phasor_times(m_mag, m_real, m_imag)
    elif per_phase_type == "linear":
        m_per = m_mag.to(m_ap.dtype)
    else:
        m_per = build_min_phase_from_mag_spec(m_mag)
    line_voi = db(build_mel_curve(0.6, h, amp=2.0, device=m_mag.device),
                  b_inv=True)
    m_per = torch.where(voi[:, None], m_per * line_voi, m_per)

    m_per = m_per * (m_mask ** 0.5)
    m_ap = m_ap * ((1.0 - m_mask) ** 0.5)
    zero = torch.zeros((), dtype=m_per.dtype, device=m_per.device)
    m_per = torch.where(m_mask == 0.0, zero, m_per)
    m_ap = torch.where(m_mask == 1.0, zero, m_ap)

    # type1 has NO abs() DC/Nyquist guard, only the hermitian zeroing of
    # their imaginary parts (magphase.py:1405)
    m_frm = _centred_frames(m_per + m_ap, fft_len)
    if anti_ringing:
        m_frm = framing.apply_anti_ringing(
            m_frm[None], shifts[None],
            torch.tensor([nfrms], device=pm.device))[0]
    return _ola_one(m_frm, pm, nfrms, out_len_max)


def _rms_ap_mask(m_mag, m_ns, valid, voi, unv, w_down, hf_slope_coeff):
    """The aperiodic mask of the type-2 and the old formulations
    (magphase.py:1536-1548, 698-709): mag over the one RMS noise gain of
    all valid frames, the voiced rows faded in by (1 - w_down), the
    unvoiced rows tilted by linspace(1, hf_slope_coeff)."""
    h = m_mag.shape[-1]
    cnt = torch.clamp(valid.sum(), min=1) * h
    rms_noise = torch.sqrt(
        torch.where(valid[:, None], torch.abs(m_ns) ** 2, 0.0).sum() / cnt)
    m_ap = m_mag / rms_noise
    m_ap = torch.where(voi[:, None], m_ap * (1.0 - w_down), m_ap)
    v_slope = torch.tensor(np.linspace(1.0, hf_slope_coeff, h),
                           dtype=m_mag.dtype, device=m_mag.device)
    return torch.where(unv[:, None], m_ap * v_slope, m_ap)


def _det_mask(m_mag, voi, unv, w_down):
    """The deterministic mask (magphase.py:1550-1553, 713-716): zero on
    unvoiced rows, mag faded out by w_down on voiced rows."""
    m = torch.where(unv[:, None], 0.0, m_mag)
    return torch.where(voi[:, None], m * w_down, m)


def _type2_core(m_mag, m_real, m_imag, v_voi, pm, shifts, nfrms: int,
                ns_len: int, key, *, fs: int, fft_len: int,
                hf_slope_coeff: float, b_voi_ap_win: bool, out_len_max: int,
                ns_len_max: int) -> torch.Tensor:
    """magphase.py:1515-1597 for one utterance: the aperiodic mask from
    mag over the RMS noise gain, the deterministic mask, the anti-ringing
    window and the overlap-add.  Returns the (out_len_max,) buffer."""
    h = fft_len // 2 + 1
    valid, voi, unv = _frame_masks(v_voi, nfrms)
    w_down = _crossfade(fs, h, m_mag)
    m_ns = noise_spectra(key, pm, voi, nfrms, ns_len, fft_len=fft_len,
                         ns_len_max=ns_len_max, b_voi_ap_win=b_voi_ap_win)
    m_ap_smth = _rms_ap_mask(m_mag, m_ns, valid, voi, unv, w_down,
                             hf_slope_coeff)
    m_det_mask = _det_mask(m_mag, voi, unv, w_down)
    m_syn = m_ap_smth * m_ns + _unit_phasor_times(m_det_mask, m_real, m_imag)
    m_frm = framing.apply_anti_ringing(
        _centred_frames(m_syn, fft_len)[None], shifts[None],
        torch.tensor([nfrms], device=pm.device))[0]
    return _ola_one(m_frm, pm, nfrms, out_len_max)


def _type1_old_masks_core(m_mag, m_real, m_imag, v_voi, pm, nfrms: int,
                          ns_len: int, key, *, fs: int, fft_len: int,
                          hf_slope_coeff: float, b_voi_ap_win: bool,
                          per_phase_type: str, ns_len_max: int):
    """Det/AP complex spectra of the OLD AP-mask formulation
    (magphase.py:675-735): one global RMS noise gain (not split voiced /
    unvoiced as the live path does), AP mask = mag/rms with a voiced
    zeros -> mask crossfade and an unvoiced HF slope; det mask = mag with
    a voiced mag -> zeros crossfade.  Returns (det, ap, det_mask)."""
    h = fft_len // 2 + 1
    valid, voi, unv = _frame_masks(v_voi, nfrms)
    w_down = _crossfade(fs, h, m_mag)
    m_ns = noise_spectra(key, pm, voi, nfrms, ns_len, fft_len=fft_len,
                         ns_len_max=ns_len_max, b_voi_ap_win=b_voi_ap_win)
    m_ap_mask = _rms_ap_mask(m_mag, m_ns, valid, voi, unv, w_down,
                             hf_slope_coeff)
    zero = torch.zeros((), dtype=m_ns.dtype, device=m_ns.device)
    m_ap_c = torch.where(m_ap_mask == 0.0, zero, m_ap_mask * m_ns)   # 710
    m_det_mask = _det_mask(m_mag, voi, unv, w_down)
    if per_phase_type == "magphase":
        m_det_c = _unit_phasor_times(m_det_mask, m_real, m_imag)
    elif per_phase_type == "linear":
        m_det_c = m_det_mask.to(m_ap_c.dtype)
    else:
        # min_phase: the reference builds the min-phase spectrum of the
        # FULL magnitude without applying the det mask (magphase.py:731-732)
        m_det_c = build_min_phase_from_mag_spec(m_mag)
    m_det_c = torch.where(m_det_mask == 0.0, zero, m_det_c)   # 735
    m_det_c = torch.where(valid[:, None], m_det_c, zero)
    m_ap_c = torch.where(valid[:, None], m_ap_c, zero)
    return m_det_c, m_ap_c, m_det_mask


def _del_comp_roundtrip(spec, mask, fft_len: int) -> torch.Tensor:
    """add_hermitian('complex') -> ifft -> fftshift -> fft -> remove
    hermitian, with the mask==0 protection re-applied (the reference's
    un-delay / re-delay steps around the 'det' Griffin-Lim,
    magphase.py:740-744 and 752-756)."""
    out = torch.fft.rfft(_centred_frames(spec, fft_len))
    return torch.where(mask == 0.0, torch.zeros((), dtype=out.dtype,
                                                device=out.device), out)


def synthesis_from_compressed_type1_old_with_griffin_lim(
        m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, fs: int,
        fft_len: int | None = None, hf_slope_coeff: float = 1.0,
        b_voi_ap_win: bool = True, b_fbank_mel: bool = False,
        const_rate_ms: float = -1.0, per_phase_type: str = "magphase",
        griff_lim_type: str | None = None,
        griff_lim_init: str = "magphase", key=None, *,
        device="cuda") -> np.ndarray:
    """magphase.py:617-794: the old AP-mask synthesis with optional
    Griffin-Lim refinement.

    griff_lim_type: None (disabled), 'det' (refine only the deterministic
    component: 10 GL iterations seeded with its own delay-compensated
    phase, magphase.py:736-757), or 'whole' (re-estimate the whole
    signal's phase with 50 min-phase-seeded GL iterations, 769-771; the
    reference passes the literal 'min', which matches none of its
    griffin_lim inits and crashes; the evident intent 'min_phase' is used,
    as in the JAX package).  griff_lim_init is accepted for signature
    parity and, as in the reference, never read.  ``key`` is split in
    two: the noise's key and the 'det' Griffin-Lim's."""
    from .griffin_lim import griffin_lim
    if key is None:
        key = prng_key(0)
    key, gl_key = split(key, 2)
    device = torch.device(device)
    (alpha, fft_len, m_mag_mel_log, m_real_mel, m_imag_mel, v_f0, v_voi,
     v_shift) = _prep_common(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0,
                             fs, fft_len)
    streams = _unwarp_streams(m_mag_mel_log, m_real_mel, m_imag_mel,
                              fft_len=fft_len, alpha=alpha,
                              b_fbank_mel=b_fbank_mel, device=device)
    if const_rate_ms > 0:   # 663-673
        streams, v_voi, v_shift = _to_variable_rate(
            streams, (v_f0 > 0).astype(np.float64), v_shift, const_rate_ms,
            fs, device)
        v_f0 = np.where(v_voi, fs / np.maximum(v_shift, 1.0), 0.0)
        v_voi = v_f0 > 1.0   # 683

    nfrms, v_shift_i, v_pm, ns_len = _geometry(v_shift)
    out_len = ns_len + 1
    F = bucket(nfrms, FRM_STEP)
    voi_p, pm_p = _rows_on(device, F, v_voi.astype(np.float32), v_pm)
    m_det, m_ap, m_det_mask = _type1_old_masks_core(
        *(pad_rows(m, F) for m in streams), voi_p, pm_p, nfrms, ns_len, key,
        fs=fs, fft_len=fft_len, hf_slope_coeff=hf_slope_coeff,
        b_voi_ap_win=b_voi_ap_win, per_phase_type=per_phase_type,
        ns_len_max=bucket_signal(ns_len))

    if griff_lim_type == "det":   # 736-757
        d = _del_comp_roundtrip(m_det, m_det_mask, fft_len)
        m_mag_gl = torch.abs(d)[:nfrms].cpu().numpy()
        _sig, m_phase_gl = griffin_lim(
            m_mag_gl, v_shift_i,
            phase_init=torch.angle(d)[:nfrms].cpu().numpy(), niters=10,
            key=gl_key, device=device)
        mag_p, phase_p = _rows_on(device, F, m_mag_gl, m_phase_gl)
        m_det = _del_comp_roundtrip(torch.polar(mag_p, phase_p), m_det_mask,
                                    fft_len)

    m_syn = m_det + m_ap
    # add_hermitian('complex') -> ifft -> fftshift -> OLA(win=None)
    # (magphase.py:762-766)
    buf = _ola_one(_centred_frames(m_syn, fft_len), pm_p, nfrms,
                   bucket_signal(out_len))
    v_syn = buf[:out_len].cpu().numpy().astype(np.float64)

    if griff_lim_type == "whole":   # 769-771
        # the re-analysed frame magnitude: fftshift only flips the sign of
        # odd bins ((-1)^k for even N), so |fft(fftshift(ifft(herm(S))))|
        # = |S| with the DC/Nyquist imaginary parts zeroed
        syn_mag = torch.abs(_real_ends(m_syn))[:nfrms].cpu().numpy()
        v_syn, _ = griffin_lim(syn_mag, v_shift_i, phase_init="min_phase",
                               niters=50, device=device)
    return _hpf_ellip(v_syn, fs)


# ---------------------------------------------------------------------------
# analysis variants

def analysis_compressed_type1(wav_file: str, fft_len: int | None = None,
                              out_dir: str | None = None, mag_dim: int = 60,
                              phase_dim: int = 45,
                              const_rate_ms: float = -1.0, *, device="cuda",
                              **kw):
    """magphase.py:2908-2942 (const_rate_ms parameterised): the compressed
    analysis, on the constant 5 ms grid when const_rate_ms > 0.  As in the
    JAX package, ``out_dir`` is accepted and not used."""
    from .compressed import analysis_compressed
    return analysis_compressed(wav_file, fft_len=fft_len, mag_dim=mag_dim,
                               phase_dim=phase_dim,
                               b_const_rate=const_rate_ms > 0, device=device,
                               **kw)


def analysis_lossless_type2(wav_file: str, fft_len: int | None = None,
                            est_file: str | None = None, pm_sec=None,
                            voi=None, *, device="cuda"):
    """magphase.py:2793-2866: even/odd pitch-mark interleaved magnitude
    analysis with a true-envelope magnitude, separate phase analysis with
    the per-frame gain.  Epochs from ``pm_sec``/``voi``, an ``est_file``,
    or the tracker.  Returns (mag_env, real, imag, f0, fs, shift, gain),
    the first frame dropped."""
    from ..epochs import extract_epochs
    from ..io import est as est_io
    from ..io import wav as wav_io
    v_sig, fs = wav_io.read_wav(wav_file)
    if pm_sec is None:
        if est_file is not None:
            pm_sec, voi = est_io.read_reaper_est_file(
                est_file, check_len_smpls=len(v_sig), fs=fs)
        else:
            pm_sec, voi = extract_epochs(v_sig, fs, device=device)
    v_pm = np.asarray(pm_sec) * fs
    voi = np.asarray(voi)

    # even/odd interleave (2806-2816)
    nx_even = np.arange(0, v_pm.size, 2)
    nx_odd = np.arange(1, v_pm.size, 2)
    me = lossless.analysis_with_del_comp_from_pm(
        v_sig, fs, v_pm[nx_even], np.ones(len(nx_even)), fft_len=fft_len,
        device=device)
    mo = lossless.analysis_with_del_comp_from_pm(
        v_sig, fs, v_pm[nx_odd], np.ones(len(nx_odd)), fft_len=fft_len,
        device=device)
    h = me[0].shape[1]
    m_mag_long = np.zeros((len(nx_even) + len(nx_odd), h))
    m_mag_long[nx_even] = me[0]
    m_mag_long[nx_odd] = mo[0]
    m_mag_long = m_mag_long[1:]

    m_mag_env = true_envelope(as_f32(m_mag_long, device), in_type="abs",
                              ncoeffs=600, thres_db=0.1).cpu().numpy()

    # phase analysis on the full mark set, type2: with the per-frame gain
    # (magphase.py:2834-2839)
    _mag, real, imag, f0, _shift, v_gain = \
        lossless.analysis_with_del_comp_from_pm_type2(
            v_sig, fs, v_pm, voi, fft_len=fft_len, device=device)
    # v_shift = la.pm_to_shift(v_pm_smpls[1:]) (magphase.py:2818)
    v_shift = np.diff(np.hstack((0.0, v_pm[1:])))
    return (m_mag_env, real[1:], imag[1:], f0[1:], fs, v_shift,
            v_gain[1:])


def analysis_compressed_type2(wav_file: str, fft_len: int | None = None,
                              out_dir: str | None = None, mag_dim: int = 60,
                              phase_dim: int = 45, b_norm_mag: bool = False,
                              const_rate_ms: float = -1.0, *, device="cuda",
                              **kw):
    """magphase.py:3123-3196: type2 analysis (true-envelope mag + per-frame
    gain), optional const-rate resampling, format_for_modelling, log-gain
    stream; b_norm_mag folds the per-frame mean of the log-mel magnitude
    into coefficient 0 (3177-3181).  With ``out_dir`` the streams go to
    <file id>.{mag,real,imag,lf0[,shift]} there and None is returned."""
    from ..io.featfile import write_featfile
    from .compressed import format_for_modelling
    from .phase_comp import _interp_f0_const_rate

    (m_mag, m_real, m_imag, v_f0, fs, v_shift,
     v_gain) = analysis_lossless_type2(wav_file, fft_len=fft_len,
                                       device=device, **kw)

    if const_rate_ms > 0.0:   # 3129-3141
        v_pm_smpls = np.cumsum(v_shift)

        def const(m):
            return framerate.interp_from_variable_to_const_frm_rate(
                m, v_pm_smpls, const_rate_ms, fs, device=device)

        m_mag, m_real, m_imag = const(m_mag), const(m_real), const(m_imag)
        v_gain = const(v_gain).cpu().numpy().squeeze()
        v_f0, _ = _interp_f0_const_rate(v_f0, v_pm_smpls, const_rate_ms, fs,
                                        device=device)

    mml, mrm, mim, v_lf0 = format_for_modelling(
        m_mag, m_real, m_imag, v_f0, fs, mag_dim=mag_dim,
        phase_dim=phase_dim, device=device)
    fft_len_out = 2 * (m_mag.shape[1] - 1)
    v_lgain = protected_log_np(np.asarray(v_gain, np.float64))

    if b_norm_mag:   # 3177-3181
        v_mean = np.mean(mml[:, 1:], axis=1)
        mml = mml - v_mean[:, None]
        v_lgain = v_mean
        mml[:, 0] = v_lgain

    if isinstance(out_dir, str):   # 3184-3194
        file_id = os.path.basename(wav_file).split(".")[0]
        write_featfile(mml, out_dir, file_id + ".mag")
        write_featfile(mrm, out_dir, file_id + ".real")
        write_featfile(mim, out_dir, file_id + ".imag")
        write_featfile(v_lf0, out_dir, file_id + ".lf0")
        if const_rate_ms <= 0.0:
            write_featfile(v_shift, out_dir, file_id + ".shift")
        return None
    return mml, mrm, mim, v_lf0, v_shift, fs, fft_len_out, v_lgain


def compute_imag_from_real(start_sign: float, v_real) -> np.ndarray:
    """magphase.py:3094-3120 (experimental, unfinished in the reference):
    the imag phase stream from real, choosing per bin the sign of
    sqrt(1-real^2) whose first difference best continues the previous
    one.  A sequential recurrence over the bins, on the host in float32
    as the JAX package's scan computes it."""
    v_real = np.asarray(v_real, np.float32)
    v_mag = np.sqrt(np.maximum(np.float32(1.0) - v_real ** 2,
                               np.float32(0.0)))
    out = np.zeros(v_real.shape[0], np.float32)
    out[1] = np.float32(start_sign) * v_mag[1]
    prev, prev2 = out[1], np.float32(0.0)
    for b in range(2, v_real.shape[0]):
        prev_diff = prev - prev2
        take_pos = abs(v_mag[b] - prev - prev_diff) <= \
            abs(-v_mag[b] - prev - prev_diff)
        out[b] = v_mag[b] if take_pos else -v_mag[b]
        prev, prev2 = out[b], prev
    return out.astype(np.float64)
