"""Epoch placement on the device (port of
magphase_tpu/epochs/placement_device.py): the tracker's walk inputs for a
batch, and the period-integrating mark walk through kernel K4
(kernels/walk.py), which dispatches by tensor device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import walk as K4
from ..utils.padding import bucket
from . import tracker


def _snap_win(fs: int) -> int:
    """Trough-search slice width: the widest searched span is the onset
    window, at most 2*SNAP_HALF_ONSET*fs/F0_MIN + 2 samples (674 at
    48 kHz), bucketed to 128 (768 at 48 kHz)."""
    return bucket(int(np.ceil(2 * tracker.SNAP_HALF_ONSET * fs / 50.0)) + 2,
                  128)


def placement_m_max(n_pad_sig: int, fs: int, frm_step: int = 128) -> int:
    """Mark-array capacity of the walk: sustained voicing at the tracker's
    F0 ceiling (400 marks/s) over the padded signal.  Callers detect
    n_marks == m_max (possible only through the monotonic guard) and redo
    those utterances with the host walk."""
    return bucket(int(np.ceil(400.0 * n_pad_sig / fs)) + 2, frm_step)


def _walk_frame_step(fs: int) -> float:
    """The tracker's frame spacing in input samples."""
    fs_a, dec = tracker.analysis_rate(fs)
    return float(round(tracker.FRAME_STEP_S * fs_a) * dec)


def _track_one(sigs: torch.Tensor, n_frames: torch.Tensor, *, fs: int,
               n_frames_max: int):
    """The walk inputs of a batch: preprocess -> NCCF -> Viterbi over the
    padded rows sigs (B, S).  Returns (y_snap (B, S), f0 (B, T),
    voiced (B, T)) float32; f0 is fs_a / the selected lag (a true float32
    division) where voiced, else 0."""
    fs_a = tracker.analysis_rate(fs)[0]
    states, lags, y_snap, valid = tracker.track_batch(
        sigs, n_frames, fs=fs, n_frames_max=n_frames_max)
    voiced = (states < tracker.N_CAND) & valid
    sel = torch.clamp(states, 0, tracker.N_CAND - 1)[..., None]
    lag_sel = torch.gather(lags, -1, sel)[..., 0]
    f0 = torch.where(voiced & (lag_sel > 0),
                     torch.full_like(lag_sel, fs_a)
                     / torch.clamp(lag_sel, min=1.0), 0.0)
    return y_snap, f0, voiced.to(torch.float32)


def place_epochs_batch(y_snap, f0, voiced, n_sigs, n_frames, *, fs: int,
                       m_max: int, frame_step: float):
    """The batched epoch walk, kernel K4 (the plain version for CPU
    tensors).  Returns (marks (B, m_max) int32, flags (B, m_max) float32,
    n_marks (B,) int32)."""
    i32 = torch.int32
    return K4.walk(y_snap.contiguous(), f0.contiguous(), voiced.contiguous(),
                   n_sigs.to(i32).contiguous(), n_frames.to(i32).contiguous(),
                   fs=fs, m_max=m_max, frame_step=frame_step,
                   snap_w=_snap_win(fs))


def track_and_place_batch(sigs, n_sigs, n_frames, *, fs: int,
                          n_frames_max: int, m_max: int):
    """Tracking + epoch placement of padded rows sigs (B, S) on their
    device.  Returns (marks, flags, n_marks) as place_epochs_batch."""
    y_snap, f0, voiced = _track_one(sigs, n_frames, fs=fs,
                                    n_frames_max=n_frames_max)
    return place_epochs_batch(y_snap, f0, voiced, n_sigs, n_frames, fs=fs,
                              m_max=m_max, frame_step=_walk_frame_step(fs))


def track_and_place_one(sig, n_sig, n_frames, *, fs: int, n_frames_max: int,
                        m_max: int):
    """One utterance on its device: preprocess -> NCCF -> Viterbi -> the
    epoch walk (K4, a batch of one).  sig (S,) padded float32 row, n_sig
    and n_frames ints or 0-d tensors.  Returns (marks (m_max,) samples,
    flags (m_max,), n_marks)."""
    dev = sig.device
    marks, flags, n_marks = track_and_place_batch(
        sig[None], torch.as_tensor(n_sig, device=dev).reshape(1),
        torch.as_tensor(n_frames, device=dev).reshape(1), fs=fs,
        n_frames_max=n_frames_max, m_max=m_max)
    return marks[0], flags[0], n_marks[0]
