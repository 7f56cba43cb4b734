"""Lossless pitch-synchronous analysis / synthesis (port of
magphase_tpu/vocoder/lossless.py): the batched cores and the host API.

analysis:  windowing + delay compensation (kernel K1) + rfft + lossless
           features (magphase.py:266-334, 457-476)
synthesis: phasor -> irfft -> fftshift -> centred OLA (kernel K2)
           (magphase.py:1759-1776 + ola 34-62)

The host API (numpy in, numpy out) pads one utterance to the JAX package's
buckets and runs the batched cores on ``device``.  f0 stays float64 on the
host, so the fs/f0 round trip of synthesis recovers the integer shifts.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import MagPhaseConfig
from ..core import framing
from ..core.windows import HANNING
from ..epochs import extract_epochs
from ..io import est as est_io
from ..io import wav as wav_io
from ..io.featfile import write_featfile
from ..utils.padding import FRM_STEP, bucket, bucket_signal, pad_to
from .framerate import f0_to_shift_np


def lossless_features(spec: torch.Tensor):
    """(mag, real, imag) of a complex spectrum: the magnitude and the unit
    phasor, (0, 0) where the magnitude is 0 (magphase.py:457-476)."""
    m_mag = torch.abs(spec)
    zero = m_mag == 0.0
    m_div = torch.where(zero, 1.0, m_mag)
    return (m_mag, torch.where(zero, 0.0, spec.real / m_div),
            torch.where(zero, 0.0, spec.imag / m_div))


def analysis_core_batch(sig, pm, nfrms, n_sig, voi, *, fft_len: int,
                        fs: int):
    """sig (B, S), pm/voi (B, F), nfrms/n_sig (B,) tensors on one device.
    Returns (mag, real, imag, f0, shift) with (B, F, ...) shapes.  The
    forward DFT is the exact torch.fft.rfft (the JAX package's
    ``rfft_mode="native"``; its matmul DFTs are TPU workarounds)."""
    frames, L, R, valid = framing.pitch_sync_frames_batch(
        sig, pm, nfrms, n_sig, fft_len, win_family=HANNING)
    m_mag, m_real, m_imag = lossless_features(torch.fft.rfft(frames))
    v_shift = L
    v_f0 = torch.where(valid & (v_shift > 0),
                       voi * fs / torch.clamp(v_shift, min=1).to(m_mag.dtype),
                       0.0)
    return m_mag, m_real, m_imag, v_f0, v_shift


def analysis_type2_core_batch(sig, pm, nfrms, n_sig, voi, *, fft_len: int):
    """analysis_with_del_comp_from_pm_type2 (magphase.py:182-260) batched:
    the lossless analysis (K1 + rfft + features) plus a per-frame gain,
    the voiced frames' max |first half of the delay-compensated frame|
    (244-246) and the unvoiced frames' std over the windowed frame
    (247-249, from sums over the padded frame: its zeros add nothing).
    Returns (mag, real, imag, shift, gain) with (B, F, ...) shapes."""
    frames, L, R, valid = framing.pitch_sync_frames_batch(
        sig, pm, nfrms, n_sig, fft_len, win_family=HANNING)
    h = fft_len // 2 + 1
    m_mag, m_real, m_imag = lossless_features(torch.fft.rfft(frames))
    gain_voi = torch.amax(torch.abs(frames[..., :h]), dim=-1)
    n = torch.clamp(L + R + 1, min=1).to(frames.dtype)
    s1 = torch.sum(frames, dim=-1)
    s2 = torch.sum(frames ** 2, dim=-1)
    var = torch.clamp(s2 / n - (s1 / n) ** 2, min=0.0)
    v_gain = torch.where(voi > 0, gain_voi, torch.sqrt(var))
    return m_mag, m_real, m_imag, L, torch.where(valid, v_gain, 0.0)


def synthesis_spectrum(m_mag, m_real, m_imag) -> torch.Tensor:
    """The complex half spectrum that synthesis inverts: magnitude times
    the normalised phasor, imag zeroed at DC and Nyquist, and the fftshift
    folded in as a (-1)^k modulation.  Inputs (B, F, H)."""
    m_ph = torch.complex(m_real, m_imag)
    m_ph_mag = torch.abs(m_ph)
    m_ph_mag = torch.where(m_ph_mag == 0.0, 1.0, m_ph_mag)
    m_fft = m_mag * m_ph / m_ph_mag
    # the reference's add_hermitian_half('complex') zeroes imag at DC/Nyquist
    m_fft[..., 0] = m_fft[..., 0].real.to(m_fft.dtype)
    m_fft[..., -1] = m_fft[..., -1].real.to(m_fft.dtype)
    # fftshift folded into the spectrum: roll by N/2 <=> (-1)^k modulation
    h = m_fft.shape[-1]
    alt = 1.0 - 2.0 * (torch.arange(h, device=m_fft.device) % 2).to(
        m_mag.dtype)
    return m_fft * alt


def synthesis_core_batch(m_mag, m_real, m_imag, pm, nfrms, *, fft_len: int,
                         out_len_max: int):
    """Phasor -> irfft -> fftshift -> centred OLA.  Inputs (B, F, H) /
    (B, F) / (B,); returns (B, out_len_max)."""
    m_frm = torch.fft.irfft(synthesis_spectrum(m_mag, m_real, m_imag),
                            n=fft_len)
    return framing.ola_centered_batch(m_frm, pm, nfrms, out_len_max)


# ---------------------------------------------------------------------------
# host API (reference-compatible signatures, numpy in/out)

def _rows(device, *arrays):
    """Each numpy array or scalar as a (1, ...) tensor on ``device``."""
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(a)[None]))
            .to(device) for a in arrays]


def densify_pitch_marks(v_pm_smpls: np.ndarray,
                        nwin_per_pitch_period: float,
                        v_voi: np.ndarray | None = None):
    """Intermediate-epoch densification (magphase.py:280-288).

    For nwin_per_pitch_period >= 1, each pitch period [pm[i], pm[i+1]) is
    subdivided into n_eps = int(nwin * 2) equal float steps; the new mark
    train is [pm0, pm0+s0, ..., pm0+(n_eps-1)s0, pm1, ...] — the final
    original mark is NOT emitted (the reference flattens the (n_eps, n-1)
    step matrix column-major and never appends pm[-1]).  Positions stay
    float; rounding happens in the windowing (magphase.py:78).

    Returns the densified marks, plus voicing repeated per sub-mark (each
    sub-window anchored in period i inherits voi[i]) when ``v_voi`` given.
    """
    v_pm = np.asarray(v_pm_smpls, np.float64)
    if nwin_per_pitch_period == 0.5:        # original design
        return (v_pm, None if v_voi is None else np.asarray(v_voi))
    if nwin_per_pitch_period < 1.0:
        raise ValueError("nwin_per_pitch_period must be 0.5 or >= 1.0 "
                         "(magphase.py:277-288)")
    n_eps = int(nwin_per_pitch_period * 2)
    v_step = np.diff(v_pm) / float(n_eps)
    m_step = np.tile(v_step, (n_eps, 1))
    m_step = m_step * np.arange(n_eps)[:, None]
    m_step = m_step + v_pm[:-1]
    pm_defi = m_step.flatten(order="F")
    if v_voi is None:
        return pm_defi, None
    voi_defi = np.repeat(np.asarray(v_voi)[:-1], n_eps)
    return pm_defi, voi_defi


def analysis_with_del_comp_from_pm(v_in_sig: np.ndarray, fs: int,
                                   v_pm_smpls: np.ndarray,
                                   v_voi: np.ndarray,
                                   fft_len: int | None = None,
                                   nwin_per_pitch_period: float = 0.5, *,
                                   device="cuda"):
    """Lossless analysis of one utterance from its pitch marks.

    v_pm_smpls: float pitch-mark positions in samples (rounded half-to-even
    here, as lu.round_to_int does at magphase.py:78).
    nwin_per_pitch_period: 0.5 = one window per two periods (the original
    design); >= 1 subdivides each period into int(nwin*2) sub-windows
    (magphase.py:280-288) before the same analysis runs.
    Returns (m_mag, m_real, m_imag, v_f0, v_shift) as numpy, nfrms rows.
    """
    cfg = MagPhaseConfig(fs=fs) if fft_len is None else \
        MagPhaseConfig(fs=fs, fft_len=fft_len)
    fft_len = cfg.fft_len
    if nwin_per_pitch_period != 0.5:
        v_pm_smpls, v_voi = densify_pitch_marks(
            v_pm_smpls, nwin_per_pitch_period, v_voi)
    pm = np.asarray(np.round(v_pm_smpls), dtype=np.int64)
    nfrms = pm.shape[0]
    n_sig = v_in_sig.shape[0]
    F = bucket(nfrms, FRM_STEP)
    S = bucket_signal(n_sig)

    sig_d, pm_d, voi_d, nfrms_d, nsig_d = _rows(
        torch.device(device), pad_to(np.asarray(v_in_sig, np.float32), S),
        pad_to(pm.astype(np.int32), F),
        pad_to(np.asarray(v_voi, np.float32), F),
        np.int32(nfrms), np.int32(n_sig))
    mag, real, imag, _f0, shift = (
        x[0, :nfrms].cpu().numpy() for x in analysis_core_batch(
            sig_d, pm_d, nfrms_d, nsig_d, voi_d, fft_len=fft_len, fs=fs))
    shift = shift.astype(np.int64)
    # f0 in float64 on the host so the fs/f0 round trip in synthesis
    # recovers the exact integer shifts (shift_to_f0, magphase.py:2198-2207,
    # b_smooth=False)
    v_f0 = np.asarray(v_voi, np.float64)[:nfrms] * fs / shift.astype(
        np.float64)
    return (mag.astype(np.float64), real.astype(np.float64),
            imag.astype(np.float64), v_f0, shift)


def analysis_with_del_comp_from_pm_type2(v_in_sig: np.ndarray, fs: int,
                                         v_pm_smpls: np.ndarray,
                                         v_voi: np.ndarray,
                                         fft_len: int | None = None, *,
                                         device="cuda"):
    """Type-2 lossless analysis of one utterance from its pitch marks
    (magphase.py:182-260, one window per two periods): the lossless
    features plus a per-frame gain (analysis_type2_core_batch).
    Returns (m_mag, m_real, m_imag, v_f0, v_shift, v_gain) as numpy."""
    cfg = MagPhaseConfig(fs=fs) if fft_len is None else \
        MagPhaseConfig(fs=fs, fft_len=fft_len)
    fft_len = cfg.fft_len
    pm = np.asarray(np.round(v_pm_smpls), dtype=np.int64)
    nfrms = pm.shape[0]
    n_sig = v_in_sig.shape[0]
    F = bucket(nfrms, FRM_STEP)
    S = bucket_signal(n_sig)
    sig_d, pm_d, voi_d, nfrms_d, nsig_d = _rows(
        torch.device(device), pad_to(np.asarray(v_in_sig, np.float32), S),
        pad_to(pm.astype(np.int32), F),
        pad_to(np.asarray(v_voi, np.float32), F),
        np.int32(nfrms), np.int32(n_sig))
    mag, real, imag, shift, gain = (
        x[0, :nfrms].cpu().numpy() for x in analysis_type2_core_batch(
            sig_d, pm_d, nfrms_d, nsig_d, voi_d, fft_len=fft_len))
    shift = shift.astype(np.int64)
    v_f0 = np.asarray(v_voi, np.float64)[:nfrms] * fs / shift.astype(
        np.float64)
    return (mag.astype(np.float64), real.astype(np.float64),
            imag.astype(np.float64), v_f0, shift, gain.astype(np.float64))


def analysis_lossless(wav_file: str, fft_len: int | None = None,
                      out_dir: str | None = None,
                      est_file: str | None = None,
                      pm_sec: np.ndarray | None = None,
                      voi: np.ndarray | None = None, *, device="cuda"):
    """Primary lossless analysis entry (magphase.py:2869-2906).

    Epochs come from (in priority order) explicit ``pm_sec``/``voi`` arrays,
    a REAPER-format ``est_file``, or the built-in epoch tracker.  With
    ``out_dir`` the features go to <file id>.{mag,real,imag,f0,shift}
    there and None is returned; else (mag, real, imag, f0, fs, shift).
    """
    v_sig, fs = wav_io.read_wav(wav_file)

    if pm_sec is None:
        if est_file is not None:
            pm_sec, voi = est_io.read_reaper_est_file(
                est_file, check_len_smpls=len(v_sig), fs=fs)
        else:
            pm_sec, voi = extract_epochs(v_sig, fs, device=device)

    v_pm_smpls = np.asarray(pm_sec) * fs
    m_mag, m_real, m_imag, v_f0, v_shift = analysis_with_del_comp_from_pm(
        v_sig, fs, v_pm_smpls, np.asarray(voi), fft_len=fft_len,
        device=device)

    if isinstance(out_dir, str):
        file_id = os.path.basename(wav_file).split(".")[0]
        write_featfile(m_mag, out_dir, file_id + ".mag")
        write_featfile(m_real, out_dir, file_id + ".real")
        write_featfile(m_imag, out_dir, file_id + ".imag")
        write_featfile(v_f0, out_dir, file_id + ".f0")
        write_featfile(v_shift, out_dir, file_id + ".shift")
        return None

    return m_mag, m_real, m_imag, v_f0, fs, v_shift


def f0_to_shift(v_f0_in: np.ndarray, fs: int,
                unv_frm_rate_ms: float = 5.0) -> np.ndarray:
    """magphase.py:2210-2215: unvoiced (f0 == 0) frames at the 5 ms rate."""
    return f0_to_shift_np(v_f0_in, fs, unv_frm_rate_ms)


def shift_to_pm(v_shift: np.ndarray) -> np.ndarray:
    return np.cumsum(v_shift)


def pm_to_shift(v_pm: np.ndarray) -> np.ndarray:
    return np.diff(np.hstack((0, v_pm)))


def synthesis_with_del_comp(m_sp: np.ndarray, m_ph: np.ndarray,
                            v_shift: np.ndarray,
                            win_flat_to_len: float = 1.0, *,
                            device="cuda") -> np.ndarray:
    """Legacy magnitude+phase OLA synthesis (magphase.py:371-419).

    The reference's default ``win_flat_to_len=0.3`` branch calls
    ``la.gen_wider_window``, which does not exist in its tree — that path
    has always raised NameError and is excluded from the capability
    surface.  Only the no-window-correction path (win_flat_to_len >= 1) is
    reproducible: frames 0..n-2 overlap-added centred at their pitch marks
    (kernel K2), output trimmed by fft_len/2 - shift[0] leading samples.
    """
    if win_flat_to_len < 1:
        raise NotImplementedError(
            "win_flat_to_len < 1 invokes la.gen_wider_window, which is "
            "undefined in the reference (magphase.py:403) — dead code.")
    v_shift = np.round(np.asarray(v_shift)).astype(np.int64)
    m_sp = np.asarray(m_sp, np.float64)
    m_ph = np.asarray(m_ph, np.float64)
    nfrms, h = m_sp.shape
    fft_len = 2 * (h - 1)
    v_pm = np.cumsum(v_shift)
    out_len = int(v_pm[-1] + fft_len - (fft_len // 2 - v_shift[0]))

    # the reference mirrors the phase via add_hermitian_half('phase'),
    # which zeroes DC and Nyquist (libaudio.py:375-377) before the ifft
    m_ph = m_ph.copy()
    m_ph[:, 0] = 0.0
    m_ph[:, -1] = 0.0

    F = bucket(nfrms, FRM_STEP)
    O = bucket_signal(out_len)
    spec = (m_sp * np.exp(1j * m_ph)).astype(np.complex64)
    m_frm = np.fft.irfft(spec, n=fft_len).astype(np.float32)
    m_frm = np.roll(m_frm, fft_len // 2, axis=1)      # fftshift (even N)
    # the reference's loop adds frames 0..nfrms-2 only (magphase.py:396-398)
    frm_d, pm_d, n_d = _rows(torch.device(device), pad_to(m_frm, F),
                             pad_to(v_pm.astype(np.int32), F),
                             np.int32(nfrms - 1))
    buf = framing.ola_centered_batch(frm_d, pm_d, n_d, O)[0]
    return buf[:out_len].cpu().numpy().astype(np.float64)


def synthesis_from_lossless(m_mag: np.ndarray, m_real: np.ndarray,
                            m_imag: np.ndarray, v_f0: np.ndarray,
                            fs: int, *, device="cuda") -> np.ndarray:
    """Lossless resynthesis (magphase.py:1759-1776): deterministic, the
    bit-matching target."""
    nfrms, h = m_mag.shape
    fft_len = 2 * (h - 1)

    v_shift = f0_to_shift(v_f0, fs)
    v_pm = np.cumsum(v_shift).astype(np.int64)   # ola() casts pm to int
    v_shift_i = pm_to_shift(v_pm)
    out_len = int(v_pm[-1] + v_shift_i[-1] + 1)

    F = bucket(nfrms, FRM_STEP)
    O = bucket_signal(out_len)
    mag_d, real_d, imag_d, pm_d, n_d = _rows(
        torch.device(device), pad_to(m_mag.astype(np.float32), F),
        pad_to(m_real.astype(np.float32), F),
        pad_to(m_imag.astype(np.float32), F),
        pad_to(v_pm.astype(np.int32), F), np.int32(nfrms))
    buf = synthesis_core_batch(mag_d, real_d, imag_d, pm_d, n_d,
                               fft_len=fft_len, out_len_max=O)[0]
    return buf[:out_len].cpu().numpy().astype(np.float64)
