"""Batched analysis from waveforms: epoch tracking, pitch-synchronous
analysis and mel compression (port of
magphase_tpu/parallel/analysis_batch.py: analysis_compressed_batch,
analysis_lossless_batch and track_f0_batch).

A request is split into groups under the frame-element budget; each group
runs two phases on the device.  Phase 1 tracks and places the epochs
(tracker + kernel K4); the (B,) mark counts come to the host; phase 2
analyses (kernel K1 + rfft), and for the compressed entry optionally
resamples to the constant 5 ms frame rate and mel-compresses, at the
realised frame bucket.  This is the JAX package's synced schedule,
whose outputs it states are bitwise those of its speculative one.  The
lossless entry's JAX program analyses at the walk capacity and slices the
frames to the realised bucket afterwards; the port analyses at the
realised bucket directly, which gives the same frames (a frame reads
only its own and its neighbours' marks, and marks past the mark count are
zeros either way).  The compressed entry's groups run through
analysis_compressed_batch_async: prepare -> upload -> both phases ->
download, a thread each (utils/pipeline.py:run_staged) and, on a card, a
CUDA stream per device stage (utils/transfer.py); the lossless entry's
groups run one after another.
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
from ..utils import transfer
from ..utils.padding import (FRM_STEP, MAX_FRAME_ELEMS, bucket,
                             bucket_frames, bucket_signal, pad_to)
from ..utils.pipeline import run_staged
from ..vocoder import framerate
from ..vocoder.compressed import (
    _format_kernel, get_num_full_mel_coeffs_from_num_phase_coeffs)
from ..vocoder.lossless import analysis_core_batch
from .batch import budget_batch_cap, capped_batch_step

logger = logging.getLogger(__name__)

FEAT_DTYPES = (np.float16, np.float32, np.uint8)
# encodings of analysis_lossless_batch's tracked features: exact float32;
# the phasor as an int16 angle; that plus a per-(utterance, bin) affine
# uint16 magnitude
TRANSPORTS = ("f32", "compact", "compact16")
_ANGLE_STEPS = float(np.float32(32768.0 / np.pi))   # int16 steps per radian

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


def _given_epochs_rows(signals, epochs, fs: int, max_b: int, device):
    """The given-epochs batch on ``device``: the batch axis padded with
    silent dummies (two marks each) to the bucket step, signals to the
    signal bucket, marks (rounded to samples) and voicing to the frame
    bucket.  Returns ((sig, pm, nfrms, n_sig, voi) tensors, the real
    utterances' frame counts, their voicing as float64)."""
    n_real = len(signals)
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

    rows = (dev(np.stack([pad_to(np.asarray(s, np.float32), S)
                          for s in signals])),
            dev(np.stack([pad_to(p.astype(np.int32), F) for p in pms])),
            dev(np.asarray(nfrms, np.int32)),
            dev(np.asarray([len(s) for s in signals], np.int32)),
            dev(np.stack([pad_to(v.astype(np.float32), F) for v in vois])))
    return rows, nfrms[:n_real], vois[:n_real]


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


def _const_resample_batch(mag, real, imag, f0, pm, nfrms, *, crs: float,
                          fc_max: int):
    """Variable -> constant 5 ms grid resampling of the batched lossless
    streams (analysis_compressed's const-rate block, magphase.py:2967-2980).
    Returns (mag, real, imag, f0) on the grid and the (B,) grid counts."""
    (mc, rc, ic), f0c, n_const = framerate.const_rate_resample_batch(
        (mag, real, imag), f0, pm, nfrms, const_rate_smpls=crs,
        fc_max=fc_max)
    return mc, rc, ic, f0c, n_const


def _fc_max(S: int, fs: int, b_const_rate: bool) -> int:
    """The constant-rate frame capacity of signal bucket S (0: variable
    rate)."""
    if not b_const_rate:
        return 0
    return bucket(int(np.ceil(S / (fs * 5.0 / 1000.0))), FRM_STEP)


def _analyze_compress_impl(sigs, marks, flags, n_marks, n_sigs, *, fs: int,
                           fft_len: int, F: int, mag_dim: int,
                           phase_dim: int, mag_dim_ph: int, alpha: float,
                           alpha_phase: float, fc_max: int = 0,
                           feats_f16: bool = False):
    """Phase 2: analysis + mel compression at the realised frame bucket F;
    with ``fc_max`` > 0 the streams are first resampled to the constant
    5 ms grid.  Returns (mag_mel_log, real_mel, imag_mel, lf0, shift,
    n_valid), (B, F or fc_max, ...), n_valid the (B,) row counts; with
    ``feats_f16`` the mel streams are rounded through float16, lf0 and
    shift stay float32/int."""
    pm = marks[:, :F]
    mag, real, imag, f0, shift = analysis_core_batch(
        sigs, pm, n_marks, n_sigs, flags[:, :F], fft_len=fft_len, fs=fs)
    n_valid = n_marks
    if fc_max > 0:
        mag, real, imag, f0, n_valid = _const_resample_batch(
            mag, real, imag, f0, pm, n_marks, crs=fs * 5.0 / 1000.0,
            fc_max=fc_max)
    mml, mrm, mim, lf0 = _compress_streams(
        mag, real, imag, f0, mag_dim=mag_dim, phase_dim=phase_dim,
        mag_dim_ph=mag_dim_ph, alpha=alpha, alpha_phase=alpha_phase)
    if feats_f16:
        mml, mrm, mim = (x.to(torch.float16) for x in (mml, mrm, mim))
    return mml, mrm, mim, lf0, shift, n_valid


def _per_utterance(mml, mrm, mim, lf0, shift, n_valid, n_marks, n_real):
    """Phase 2's outputs (host arrays), one (mag_mel_log, real_mel,
    imag_mel, lf0, shift) tuple per real utterance: n_valid[b] rows of the
    streams, n_marks[b] shifts."""
    out = []
    for b in range(n_real):
        n = int(n_valid[b])
        out.append((mml[b, :n].astype(np.float64),
                    mrm[b, :n].astype(np.float64),
                    mim[b, :n].astype(np.float64),
                    lf0[b, :n].astype(np.float64),
                    shift[b, :int(n_marks[b])].astype(np.int64)))
    return out


def _encode_u8(mml, mrm, mim, n_valid):
    """The uint8 transfer encoding of the mel streams, on their device: the
    (B, F, D) concatenation as round((x - lo) / scale) in [0, 255], with lo
    and scale = (hi - lo) / 255 per (utterance, coefficient) over the
    n_valid rows (scale 1 where hi == lo), divided tensor by tensor as the
    JAX package divides (P2).  Returns (q uint8, scale, lo) float32."""
    feats = torch.cat([mml, mrm, mim], dim=-1)
    F = feats.shape[1]
    valid = (torch.arange(F, device=feats.device)[None, :, None]
             < n_valid[:, None, None])
    big = 3.0e38
    lo = torch.amin(torch.where(valid, feats, big), dim=1)
    hi = torch.amax(torch.where(valid, feats, -big), dim=1)
    lo = torch.minimum(lo, hi)
    scale = torch.where(hi > lo, (hi - lo) / torch.full_like(hi, 255.0), 1.0)
    q = torch.clamp(torch.round((feats - lo[:, None, :]) / scale[:, None, :]),
                    0, 255).to(torch.uint8)
    return q, scale, lo


def _check_options(mesh, feat_dtype) -> None:
    if mesh is not None:
        raise ValueError("mesh must be None: multi-device analysis is not "
                         "supported")
    if not any(np.dtype(feat_dtype) == np.dtype(d) for d in FEAT_DTYPES):
        raise ValueError(f"feat_dtype={feat_dtype!r}: np.float16, np.float32 "
                         "or np.uint8")
    tracker.nccf_whiten_mode()


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
    lf0 (n,)) float64 and shift (n,) int64 numpy arrays, one per signal;
    with ``b_const_rate`` the streams are on the constant 5 ms grid while
    shift stays the variable-rate track (analysis_compressed's contract,
    magphase.py:2947-2988).

    ``epochs=None``: the built-in tracker places the epochs (phase 1),
    then analysis + compression run at the realised frame bucket (phase
    2), through analysis_compressed_batch_async.  ``feat_dtype``:
    np.float16 (the JAX package's default: the mel streams rounded through
    float16, lf0 and shift float32), np.float32, or np.uint8 (the mel
    streams through per-(utterance, coefficient) affine uint8 codes,
    variable rate only; constant rate falls back to float16, as in the JAX
    package).  ``epochs``: a list of (pm_sec, voi) per signal instead of
    the tracker; as in the JAX package, that branch returns float32
    streams whatever ``feat_dtype`` says.  ``device``: where the work
    runs.

    Not ported: a ``mesh`` (ValueError).  An unknown
    MAGPHASE_TRACKER_WHITEN value raises ValueError too."""
    _check_options(mesh, feat_dtype)
    device = torch.device(device)
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], phase_dim, alpha_phase, fs)
    kw = dict(fft_len=fft_len, mag_dim=mag_dim, phase_dim=phase_dim,
              mag_dim_ph=mag_dim_ph, alpha=alpha, alpha_phase=alpha_phase,
              b_const_rate=b_const_rate)

    if epochs is None:
        return analysis_compressed_batch_async(
            signals, fs, mag_dim=mag_dim, phase_dim=phase_dim,
            fft_len=fft_len, alpha_phase=alpha_phase,
            b_const_rate=b_const_rate, feat_dtype=feat_dtype,
            device=device)()

    max_b = _epochs_budget(epochs, fft_len)
    if len(signals) > max_b:
        out = []
        for i in range(0, len(signals), max_b):
            out.extend(analysis_compressed_batch(
                signals[i:i + max_b], fs, mag_dim=mag_dim,
                phase_dim=phase_dim, fft_len=fft_len,
                epochs=epochs[i:i + max_b], alpha_phase=alpha_phase,
                b_const_rate=b_const_rate, device=device))
        return out
    rows, nfrms, _ = _given_epochs_rows(signals, epochs, fs, max_b, device)
    sig, pm, nfrms_d = rows[:3]
    mag, real, imag, f0, shift = analysis_core_batch(*rows, fft_len=fft_len,
                                                     fs=fs)
    n_valid = nfrms_d
    if b_const_rate:
        mag, real, imag, f0, n_valid = _const_resample_batch(
            mag, real, imag, f0, pm, nfrms_d, crs=fs * 5.0 / 1000.0,
            fc_max=_fc_max(sig.shape[1], fs, True))
    mml, mrm, mim, lf0 = _compress_streams(
        mag, real, imag, f0, **{k: v for k, v in kw.items()
                                if k not in ("fft_len", "b_const_rate")})
    host = transfer.to_host((mml, mrm, mim, lf0, shift, n_valid), None, None)
    return _per_utterance(*host, nfrms, len(nfrms))


def analysis_compressed_batch_async(signals: list, fs: int,
                                    mag_dim: int = 60, phase_dim: int = 45,
                                    fft_len: int | None = None,
                                    alpha_phase: float | None = None,
                                    b_const_rate: bool = False,
                                    mesh=None, feat_dtype=np.float16, *,
                                    device="cuda"):
    """Threaded tracking -> analysis + compression of one utterance batch;
    work starts at once, returns ``finalize() -> feats`` (the list
    analysis_compressed_batch returns).

    Each budget group runs prepare (host rows) -> upload -> compute (phase
    1, the (B,) mark counts to the host, phase 2 at the realised frame
    bucket, and the uint8 encode) -> download, a thread each
    (utils/pipeline.py:run_staged), and on a card a CUDA stream per device
    stage (utils/transfer.py).  The phases are analysis_compressed_batch's,
    so the features are the same.  ``feat_dtype``: np.float16, np.float32
    or np.uint8 (variable rate; constant rate falls back to float16), as
    in analysis_compressed_batch.  A stage that raises tears the pipeline
    down and re-raises in ``finalize``."""
    _check_options(mesh, feat_dtype)
    device = torch.device(device)
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], phase_dim, alpha_phase, fs)
    ckw = dict(mag_dim=mag_dim, phase_dim=phase_dim, mag_dim_ph=mag_dim_ph,
               alpha=alpha, alpha_phase=alpha_phase)
    if np.dtype(feat_dtype) == np.uint8:
        enc = "f16" if b_const_rate else "u8"
    else:
        enc = "f16" if np.dtype(feat_dtype) == np.float16 else "f32"
    legs = transfer.Legs(device)

    def prep(group):
        signals_g, host, S, Tmax, m_max, n_real = _host_signal_batch(
            group, fs, fft_len)
        return dict(signals=signals_g, host=host, S=S, Tmax=Tmax,
                    m_max=m_max, n_real=n_real)

    def upload(p):
        p["dev"], p["event"] = transfer.upload(p.pop("host"), device,
                                               legs.upload)
        return p

    def compute(p):
        with transfer.on(legs.compute):
            sigs, n_sigs, n_frames = p.pop("dev")
            transfer.adopt((sigs, n_sigs, n_frames), legs.compute,
                           p["event"])
            marks, flags, n_marks = _track_place_impl(
                sigs, n_sigs, n_frames, fs=fs, n_frames_max=p["Tmax"],
                m_max=p["m_max"])
            p["nm"] = n_marks.cpu().numpy()
            Fa = min(p["m_max"], bucket_frames(int(p["nm"].max())))
            *outs, n_valid = _analyze_compress_impl(
                sigs, marks, flags, n_marks, n_sigs, fs=fs, fft_len=fft_len,
                F=Fa, fc_max=_fc_max(p["S"], fs, b_const_rate),
                feats_f16=enc == "f16", **ckw)
            if enc == "u8":
                outs = list(_encode_u8(*outs[:3], n_valid)) + outs[3:]
            p["out"] = tuple(outs) + (n_valid,)
            p["event"] = transfer.record(legs.compute)
        return p

    def download(p):
        global capacity_fallbacks
        host = transfer.to_host(p.pop("out"), legs.download, p.pop("event"))
        nm, n_real = p["nm"], p["n_real"]
        if enc == "u8":
            q, scale, lo, lf0, shift, n_valid = host
            out = []
            for b in range(n_real):
                n = int(n_valid[b])
                f = q[b, :n].astype(np.float64) * scale[b] + lo[b]
                out.append((f[:, :mag_dim], f[:, mag_dim:mag_dim + phase_dim],
                            f[:, mag_dim + phase_dim:],
                            lf0[b, :n].astype(np.float64),
                            shift[b, :int(nm[b])].astype(np.int64)))
        else:
            out = _per_utterance(*host, nm, n_real)

        # a walk that hit its capacity (pathological mark density) is
        # redone with the host walk and the given-epochs branch, as the
        # JAX package does
        trunc = [b for b in range(n_real) if int(nm[b]) >= p["m_max"]]
        if trunc:
            logger.warning("epoch-walk capacity hit for %d utterance(s); "
                           "host-walk fallback", len(trunc))
            capacity_fallbacks += len(trunc)
            eps = [tracker.extract_epochs(p["signals"][b], fs, device=device)
                   for b in trunc]
            fixed = analysis_compressed_batch(
                [p["signals"][b] for b in trunc], fs, mag_dim=mag_dim,
                phase_dim=phase_dim, fft_len=fft_len,
                alpha_phase=alpha_phase, b_const_rate=b_const_rate,
                epochs=eps, device=device)
            for j, b in enumerate(trunc):
                out[b] = fixed[j]
        return out

    groups = _split_for_budget(signals, fs, fft_len)
    pipe = run_staged(map(prep, groups), [upload, compute, download])

    def finalize():
        out = []
        for chunk in pipe:
            out.extend(chunk)
        return out

    return finalize


# ---------------------------------------------------------------------------
# lossless analysis

def _encode_lossless(mag, real, imag, n_marks, transport: str):
    """The tracked features in ``transport``'s encoding, on their device:
    'f32' (mag, real, imag); 'compact' (mag, the phasor's angle as int16
    steps of pi/32768, rounded half to even as jnp.rint); 'compact16'
    (the magnitude as round((mag - lo) / scale) in [0, 65535], with lo and
    scale = (hi - lo) / 65535 per (utterance, bin) over the valid frames,
    and the int16 angle)."""
    if transport == "f32":
        return dict(mag=mag, real=real, imag=imag)
    ang_i16 = torch.clamp(torch.round(torch.atan2(imag, real)
                                      * _ANGLE_STEPS),
                          -32768, 32767).to(torch.int16)
    if transport == "compact":
        return dict(mag=mag, ang=ang_i16)
    F = mag.shape[1]
    valid = (torch.arange(F, device=mag.device)[None, :, None]
             < n_marks[:, None, None])
    big = 3.0e38
    lo = torch.amin(torch.where(valid, mag, big), dim=1)
    hi = torch.amax(torch.where(valid, mag, -big), dim=1)
    lo = torch.minimum(lo, hi)
    scale = torch.where(hi > lo, (hi - lo) / 65535.0, 1.0)
    q = torch.clamp(torch.round((mag - lo[:, None, :]) / scale[:, None, :]),
                    0, 65535).to(torch.int32)
    return dict(q=q, ang=ang_i16, scale=scale, lo=lo)


def _decode_lossless(enc: dict, b: int, n: int):
    """(mag, real, imag) float32 of utterance b's first n frames from the
    host copy of ``_encode_lossless``'s output, as the JAX package decodes
    it; a digitally silent bin (mag 0) keeps the phasor (0, 0) of the exact
    transport."""
    if "real" in enc:
        return enc["mag"][b, :n], enc["real"][b, :n], enc["imag"][b, :n]
    if "q" in enc:
        mag = (enc["q"][b, :n].astype(np.float64) * enc["scale"][b]
               + enc["lo"][b]).astype(np.float32)
    else:
        mag = enc["mag"][b, :n]
    a = enc["ang"][b, :n].astype(np.float64) * (np.pi / 32768.0)
    nz = mag > 0.0
    return (mag, np.where(nz, np.cos(a), 0.0).astype(np.float32),
            np.where(nz, np.sin(a), 0.0).astype(np.float32))


def _analyze_lossless_tracked_group(group, fs, *, fft_len, transport,
                                    device):
    """Phase 1 and the lossless analysis for one budget group of the
    tracked branch, at the realised frame bucket (a multiple of 128, as the
    JAX package trims to)."""
    global capacity_fallbacks
    signals_g, host, S, Tmax, m_max, n_real = _host_signal_batch(
        group, fs, fft_len)
    sigs, n_sigs, n_frames = (torch.from_numpy(a).to(device) for a in host)
    marks, flags, n_marks = _track_place_impl(
        sigs, n_sigs, n_frames, fs=fs, n_frames_max=Tmax, m_max=m_max)
    nm = n_marks.cpu().numpy()
    Fa = min(m_max, bucket(int(nm.max()), FRM_STEP))
    mag, real, imag, _f0, shift = analysis_core_batch(
        sigs, marks[:, :Fa], n_marks, n_sigs, flags[:, :Fa],
        fft_len=fft_len, fs=fs)
    enc = {k: v.cpu().numpy() for k, v in _encode_lossless(
        mag, real, imag, n_marks, transport).items()}
    shift, flags = shift.cpu().numpy(), flags[:, :Fa].cpu().numpy()
    out = []
    for b in range(n_real):
        n = int(nm[b])
        sh = shift[b, :n].astype(np.int64)
        f0 = (flags[b, :n].astype(np.float64) * fs
              / np.maximum(sh, 1).astype(np.float64))
        out.append(_decode_lossless(enc, b, n) + (f0, sh))

    # a walk that hit its capacity is redone with the host walk and the
    # given-epochs branch, as the JAX package does
    trunc = [b for b in range(n_real) if int(nm[b]) >= m_max]
    if trunc:
        logger.warning("epoch-walk capacity hit for %d utterance(s); "
                       "host-walk fallback", len(trunc))
        capacity_fallbacks += len(trunc)
        eps = [tracker.extract_epochs(signals_g[b], fs, device=device)
               for b in trunc]
        fixed = analysis_lossless_batch(
            [signals_g[b] for b in trunc], fs, fft_len=fft_len, epochs=eps,
            device=device)
        for j, b in enumerate(trunc):
            out[b] = fixed[j]
    return out


def analysis_lossless_batch(signals: list, fs: int,
                            fft_len: int | None = None,
                            epochs: list | None = None,
                            mesh=None, transport: str = "f32", *,
                            device="cuda"):
    """Batched lossless analysis of waveforms.  Returns a list of
    (m_mag, m_real, m_imag) float32 (n, fft_len/2+1), v_f0 float64 (n,)
    and v_shift int64 (n,) numpy arrays, one per signal.

    ``epochs=None``: the built-in tracker places the epochs (phase 1), then
    the analysis runs at the realised frame bucket.  ``transport`` (tracked
    branch): 'f32' (exact), 'compact' (the phasor through an int16 angle)
    or 'compact16' (that, and the magnitude through a per-(utterance, bin)
    affine uint16), each decoded on the host as the JAX package does.
    ``epochs``: a list of (pm_sec, voi) per signal instead of the tracker;
    that branch returns the exact features whatever ``transport`` says, as
    in the JAX package.  ``device``: where the work runs.

    Raise ValueError: a ``mesh`` (multi-device analysis is not ported) and
    any ``transport`` outside TRANSPORTS."""
    if mesh is not None:
        raise ValueError("mesh must be None: multi-device analysis is not "
                         "supported")
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; one of "
                         f"{TRANSPORTS}")
    device = torch.device(device)
    if fft_len is None:
        fft_len = define_fft_len(fs)

    if epochs is None:
        out = []
        for group in _split_for_budget(signals, fs, fft_len):
            out.extend(_analyze_lossless_tracked_group(
                group, fs, fft_len=fft_len, transport=transport,
                device=device))
        return out

    max_b = _epochs_budget(epochs, fft_len)
    if len(signals) > max_b:
        out = []
        for i in range(0, len(signals), max_b):
            out.extend(analysis_lossless_batch(
                signals[i:i + max_b], fs, fft_len=fft_len,
                epochs=epochs[i:i + max_b], device=device))
        return out
    rows, nfrms, vois = _given_epochs_rows(signals, epochs, fs, max_b,
                                           device)
    mag, real, imag, _f0, shift = analysis_core_batch(*rows, fft_len=fft_len,
                                                      fs=fs)
    mag, real, imag, shift = (x.cpu().numpy()
                              for x in (mag, real, imag, shift))
    out = []
    for b, n in enumerate(nfrms):
        sh = shift[b, :n].astype(np.int64)
        out.append((mag[b, :n], real[b, :n], imag[b, :n],
                    vois[b][:n] * fs / sh.astype(np.float64), sh))
    return out


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
