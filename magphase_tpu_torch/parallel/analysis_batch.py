"""Batched compressed analysis from waveforms: epoch tracking, pitch-
synchronous analysis and mel compression (port of
magphase_tpu/parallel/analysis_batch.py: analysis_compressed_batch and
track_f0_batch).

A request is split into groups under the frame-element budget; each group
runs two phases on the device.  Phase 1 tracks and places the epochs
(tracker + kernel K4); the (B,) mark counts come to the host; phase 2
analyses (kernel K1 + rfft) and mel-compresses at the realised frame
bucket.  This is the JAX package's synced schedule, whose outputs it
states are bitwise those of its speculative one.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import define_alpha, define_crossfade_params, define_fft_len
from ..core.filters import medfilt3
from ..core.spectral import f0_to_lf0
from ..epochs import tracker
from ..epochs.placement_device import placement_m_max, track_and_place_batch
from ..utils.padding import (FRM_STEP, MAX_FRAME_ELEMS, bucket,
                             bucket_frames, bucket_signal, pad_to)
from ..vocoder.compressed import (
    _format_kernel, get_num_full_mel_coeffs_from_num_phase_coeffs)
from ..vocoder.lossless import analysis_core_batch
from .batch import budget_batch_cap, capped_batch_step

logger = logging.getLogger(__name__)

FEAT_DTYPES = (np.float16, np.float32)

# utterances redone with the host walk because the device walk hit its
# mark capacity (n_marks == m_max), since the process started
capacity_fallbacks = 0


def _tracker_frame_geometry(signals: list, fs: int):
    """Per-utterance NCCF frame counts and their bucketed maximum."""
    n_frames = np.asarray([tracker.n_tracker_frames(len(s), fs)
                           for s in signals], np.int32)
    return n_frames, bucket(int(n_frames.max()), 128)


def _budget_geometry(signals: list, fs: int, fft_len: int):
    """(S, m_max, max_batch): the signal bucket, the walk capacity of the
    longest utterance and the largest batch whose frames stay inside the
    frame-element budget."""
    S = bucket_signal(max(len(s) for s in signals))
    m_max = placement_m_max(S, fs, FRM_STEP)
    max_b = max(1, int(MAX_FRAME_ELEMS // (m_max * fft_len)))
    return S, m_max, budget_batch_cap(max_b)


def _split_for_budget(signals: list, fs: int, fft_len: int):
    """An utterance list in groups that each fit the budget."""
    max_b = _budget_geometry(signals, fs, fft_len)[2]
    if len(signals) <= max_b:
        return [signals]
    return [signals[i:i + max_b] for i in range(0, len(signals), max_b)]


def _epochs_budget(epochs, fft_len: int) -> int:
    """Max batch of the given-epochs branch under the budget (the frame
    axis comes from the given epochs)."""
    F_est = bucket(max(len(p) for p, _ in epochs), FRM_STEP)
    return budget_batch_cap(max(1, int(MAX_FRAME_ELEMS // (F_est * fft_len))))


def _host_signal_batch(signals: list, fs: int, fft_len: int = 4096):
    """Host half of a group: the batch axis padded with short silent
    dummies to the bucket step, float32 rows (B, S), and the tracker
    geometry.  Returns (signals incl. dummies, (sigs, n_sigs, n_frames),
    S, Tmax, m_max, n_real)."""
    n_real = len(signals)
    S, m_max, max_b = _budget_geometry(signals, fs, fft_len)
    B = bucket(n_real, capped_batch_step(max_b))
    if B > n_real:
        signals = list(signals) + [np.zeros(1024)] * (B - n_real)
    sigs = np.zeros((B, S), np.float32)
    for b, s in enumerate(signals):
        sigs[b, :len(s)] = s
    n_sigs = np.asarray([len(s) for s in signals], np.int32)
    n_frames, Tmax = _tracker_frame_geometry(signals, fs)
    return signals, (sigs, n_sigs, n_frames), S, Tmax, m_max, n_real


def _track_place_impl(sigs, n_sigs, n_frames, *, fs: int,
                      n_frames_max: int, m_max: int):
    """Phase 1: tracking + epoch placement.  Returns (marks, flags,
    n_marks) on the device of ``sigs``."""
    return track_and_place_batch(sigs, n_sigs, n_frames, fs=fs,
                                 n_frames_max=n_frames_max, m_max=m_max)


def _compress_streams(mag, real, imag, f0, *, mag_dim, phase_dim,
                      mag_dim_ph, alpha, alpha_phase):
    """(B, F, h) lossless streams -> (B, F, dims) compressed streams and
    lf0 (format_for_modelling, magphase.py:2490-2544, with the 3-point
    median smoothing of f0 on the device)."""
    B, F, h = mag.shape
    voi_f = (f0 > 0).to(mag.dtype)
    mml, mrm, mim = _format_kernel(
        mag.reshape(B * F, h), real.reshape(B * F, h),
        imag.reshape(B * F, h), voi_f.reshape(B * F), mag_dim=mag_dim,
        phase_dim=phase_dim, mag_dim_ph=mag_dim_ph, alpha=alpha,
        alpha_phase=alpha_phase)
    lf0 = f0_to_lf0(voi_f * medfilt3(f0))
    return (mml.reshape(B, F, mag_dim), mrm.reshape(B, F, phase_dim),
            mim.reshape(B, F, phase_dim), lf0)


def _analyze_compress_impl(sigs, marks, flags, n_marks, n_sigs, *, fs: int,
                           fft_len: int, F: int, mag_dim: int,
                           phase_dim: int, mag_dim_ph: int, alpha: float,
                           alpha_phase: float, feats_f16: bool = False):
    """Phase 2: analysis + mel compression at the realised frame bucket F.
    Returns (mag_mel_log, real_mel, imag_mel, lf0, shift), (B, F, ...);
    with ``feats_f16`` the mel streams are rounded through float16, lf0 and
    shift stay float32/int."""
    mag, real, imag, f0, shift = analysis_core_batch(
        sigs, marks[:, :F], n_marks, n_sigs, flags[:, :F], fft_len=fft_len,
        fs=fs)
    mml, mrm, mim, lf0 = _compress_streams(
        mag, real, imag, f0, mag_dim=mag_dim, phase_dim=phase_dim,
        mag_dim_ph=mag_dim_ph, alpha=alpha, alpha_phase=alpha_phase)
    if feats_f16:
        mml, mrm, mim = (x.to(torch.float16) for x in (mml, mrm, mim))
    return mml, mrm, mim, lf0, shift


def _check_options(b_const_rate, mesh, feat_dtype) -> None:
    if b_const_rate:
        raise ValueError("b_const_rate=True: constant frame rate output is "
                         "not ported")
    if mesh is not None:
        raise ValueError("mesh must be None: multi-device analysis is not "
                         "supported")
    if not any(np.dtype(feat_dtype) == np.dtype(d) for d in FEAT_DTYPES):
        raise ValueError(f"feat_dtype={feat_dtype!r}: only np.float16 and "
                         "np.float32 are supported")
    tracker.nccf_whiten_mode()


def _analyze_tracked_group(group, fs, *, fft_len, mag_dim, phase_dim,
                           mag_dim_ph, alpha, alpha_phase, feats_f16,
                           device):
    """Both phases for one budget group of the tracked branch."""
    global capacity_fallbacks
    signals_g, host, S, Tmax, m_max, n_real = _host_signal_batch(
        group, fs, fft_len)
    sigs, n_sigs, n_frames = (torch.from_numpy(a).to(device) for a in host)
    marks, flags, n_marks = _track_place_impl(
        sigs, n_sigs, n_frames, fs=fs, n_frames_max=Tmax, m_max=m_max)
    nm = n_marks.cpu().numpy()
    Fa = min(m_max, bucket_frames(int(nm.max())))
    mml, mrm, mim, lf0, shift = _analyze_compress_impl(
        sigs, marks, flags, n_marks, n_sigs, fs=fs, fft_len=fft_len, F=Fa,
        mag_dim=mag_dim, phase_dim=phase_dim, mag_dim_ph=mag_dim_ph,
        alpha=alpha, alpha_phase=alpha_phase, feats_f16=feats_f16)
    mml, mrm, mim, lf0, shift = (x.cpu().numpy()
                                 for x in (mml, mrm, mim, lf0, shift))
    out = []
    for b in range(n_real):
        n = int(nm[b])
        out.append((mml[b, :n].astype(np.float64),
                    mrm[b, :n].astype(np.float64),
                    mim[b, :n].astype(np.float64),
                    lf0[b, :n].astype(np.float64),
                    shift[b, :n].astype(np.int64)))

    # a walk that hit its capacity (pathological mark density) is redone
    # with the host walk and the given-epochs branch, as the JAX package
    # does
    trunc = [b for b in range(n_real) if int(nm[b]) >= m_max]
    if trunc:
        logger.warning("epoch-walk capacity hit for %d utterance(s); "
                       "host-walk fallback", len(trunc))
        capacity_fallbacks += len(trunc)
        eps = [tracker.extract_epochs(signals_g[b], fs, device=device)
               for b in trunc]
        fixed = analysis_compressed_batch(
            [signals_g[b] for b in trunc], fs, mag_dim=mag_dim,
            phase_dim=phase_dim, fft_len=fft_len, alpha_phase=alpha_phase,
            epochs=eps, device=device)
        for j, b in enumerate(trunc):
            out[b] = fixed[j]
    return out


def analysis_compressed_batch(signals: list, fs: int, mag_dim: int = 60,
                              phase_dim: int = 45,
                              fft_len: int | None = None,
                              epochs: list | None = None,
                              alpha_phase: float | None = None,
                              b_const_rate: bool = False,
                              mesh=None, feat_dtype=np.float16, *,
                              device="cuda"):
    """Batched compressed analysis of waveforms.  Returns a list of
    (mag_mel_log (n, mag_dim), real_mel (n, phase_dim), imag_mel,
    lf0 (n,)) float64 and shift (n,) int64 numpy arrays, one per signal.

    ``epochs=None``: the built-in tracker places the epochs (phase 1),
    then analysis + compression run at the realised frame bucket (phase
    2).  ``feat_dtype``: np.float16 (the JAX package's default: the mel
    streams rounded through float16, lf0 and shift float32) or np.float32.
    ``epochs``: a list of (pm_sec, voi) per signal instead of the tracker;
    as in the JAX package, that branch returns float32 streams whatever
    ``feat_dtype`` says.  ``device``: where the work runs.

    Not ported, each raising ValueError: ``b_const_rate=True``, a
    ``mesh``, ``feat_dtype=np.uint8`` and any MAGPHASE_TRACKER_WHITEN other
    than 'none'."""
    _check_options(b_const_rate, mesh, feat_dtype)
    device = torch.device(device)
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], phase_dim, alpha_phase, fs)
    kw = dict(fft_len=fft_len, mag_dim=mag_dim, phase_dim=phase_dim,
              mag_dim_ph=mag_dim_ph, alpha=alpha, alpha_phase=alpha_phase)

    if epochs is None:
        feats_f16 = np.dtype(feat_dtype) == np.float16
        out = []
        for group in _split_for_budget(signals, fs, fft_len):
            out.extend(_analyze_tracked_group(
                group, fs, feats_f16=feats_f16, device=device, **kw))
        return out

    n_real = len(signals)
    max_b = _epochs_budget(epochs, fft_len)
    if n_real > max_b:
        out = []
        for i in range(0, n_real, max_b):
            out.extend(analysis_compressed_batch(
                signals[i:i + max_b], fs, mag_dim=mag_dim,
                phase_dim=phase_dim, fft_len=fft_len,
                epochs=epochs[i:i + max_b], alpha_phase=alpha_phase,
                device=device))
        return out
    B = bucket(n_real, capped_batch_step(max_b))
    if B > n_real:
        d_ep = (np.asarray([100, 300]) / float(fs), np.zeros(2))
        signals = list(signals) + [np.zeros(1024)] * (B - n_real)
        epochs = list(epochs) + [d_ep] * (B - n_real)

    pms = [np.asarray(np.round(np.asarray(p) * fs), np.int64)
           for p, _ in epochs]
    vois = [np.asarray(v, np.float64) for _, v in epochs]
    nfrms = [len(p) for p in pms]
    S = bucket_signal(max(len(s) for s in signals))
    F = bucket(max(nfrms), FRM_STEP)

    def dev(a):
        return torch.from_numpy(a).to(device)

    sigs_d = dev(np.stack([pad_to(np.asarray(s, np.float32), S)
                           for s in signals]))
    pm_d = dev(np.stack([pad_to(p.astype(np.int32), F) for p in pms]))
    voi_d = dev(np.stack([pad_to(v.astype(np.float32), F) for v in vois]))
    nfrms_d = dev(np.asarray(nfrms, np.int32))
    nsig_d = dev(np.asarray([len(s) for s in signals], np.int32))
    mag, real, imag, f0, shift = analysis_core_batch(
        sigs_d, pm_d, nfrms_d, nsig_d, voi_d, fft_len=fft_len, fs=fs)
    mml, mrm, mim, lf0 = _compress_streams(
        mag, real, imag, f0, **{k: v for k, v in kw.items()
                                if k != "fft_len"})
    mml, mrm, mim, lf0, shift = (x.cpu().numpy()
                                 for x in (mml, mrm, mim, lf0, shift))
    return [(mml[b, :n].astype(np.float64), mrm[b, :n].astype(np.float64),
             mim[b, :n].astype(np.float64), lf0[b, :n].astype(np.float64),
             shift[b, :n].astype(np.int64))
            for b, n in enumerate(nfrms[:n_real])]


def track_f0_batch(signals: list, fs: int, *, device="cuda"):
    """Batched F0 tracks: a list of (f0, voiced, y_snap) numpy arrays."""
    S = bucket_signal(max(len(s) for s in signals))
    sigs = np.stack([pad_to(np.asarray(s, np.float32), S) for s in signals])
    n_frames, Tmax = _tracker_frame_geometry(signals, fs)
    states, lags, y_snap, _ = tracker.track_batch(
        torch.from_numpy(sigs).to(device),
        torch.from_numpy(n_frames).to(device), fs=fs, n_frames_max=Tmax)
    states, lags, y_snap = (x.cpu().numpy() for x in (states, lags, y_snap))
    out = []
    for b, sig in enumerate(signals):
        nf = int(n_frames[b])
        f0, voiced = tracker.f0_from_states(states[b, :nf], lags[b, :nf], fs)
        out.append((f0, voiced, y_snap[b, :len(sig)]))
    return out
