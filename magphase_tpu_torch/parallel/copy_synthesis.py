"""Batched lossless copy-synthesis: wav in -> wav out on one device (port
of magphase_tpu/parallel/copy_synthesis.py).

Per budget group, all on the device:
  preprocess -> NCCF -> Viterbi -> epoch walk (kernel K4)   phase 1
  pitch-synchronous analysis (kernel K1) + rfft             phase 2
  phasor resynthesis + irfft + centred OLA (kernel K2)

This is the reference's demo_copy_synthesis_lossless.py workload.
Synthesis uses the pitch marks directly (the f0 -> shift -> cumsum detour
of magphase.py:1771-1772 is an exact round trip when the features are not
stored in between).  Phase 2 runs at the realised frame bucket, after one
(B,) mark-count fetch, where the JAX program runs it at the walk capacity:
the OLA adds only frames below each utterance's mark count, so the
samples are the same.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..epochs.placement_device import track_and_place_batch
from ..utils.padding import bucket, bucket_frames
from ..vocoder.lossless import analysis_core_batch, synthesis_core_batch
from .analysis_batch import _budget_geometry, _tracker_frame_geometry
from .batch import capped_batch_step

logger = logging.getLogger(__name__)


def _copy_synthesis_impl(sigs, n_sigs, n_frames, *, fs: int,
                         n_frames_max: int, m_max: int, fft_len: int,
                         out_len_max: int):
    """(B, S) signals -> (B, out_len_max) resynthesised signals on their
    device, the (B,) mark counts there, and the same counts on the host."""
    marks, flags, n_marks = track_and_place_batch(
        sigs, n_sigs, n_frames, fs=fs, n_frames_max=n_frames_max,
        m_max=m_max)
    nm = n_marks.cpu().numpy()
    F = min(m_max, bucket_frames(int(nm.max())))
    marks, flags = marks[:, :F], flags[:, :F]
    mag, real, imag, _f0, _shift = analysis_core_batch(
        sigs, marks, n_marks, n_sigs, flags, fft_len=fft_len, fs=fs)
    bufs = synthesis_core_batch(mag, real, imag, marks, n_marks,
                                fft_len=fft_len, out_len_max=out_len_max)
    return bufs, n_marks, nm


def copy_synthesis_batch(signals: list, fs: int, fft_len: int = 4096,
                         mesh=None, block_result: bool = True, *,
                         device="cuda"):
    """Batched lossless copy-synthesis.  Returns a list of float64
    waveforms, each as long as its input; with ``block_result=False`` the
    (B, out_len) float32 buffer on ``device`` (rows past the request are
    silent dummies) and the (B,) mark counts there — for a request split
    into budget groups, a list of rows and a list of counts.

    Raise ValueError: a ``mesh`` (multi-device synthesis is not ported)."""
    if mesh is not None:
        raise ValueError("mesh must be None: multi-device copy-synthesis is "
                         "not supported")
    device = torch.device(device)
    # frame-element budget: split oversized batches into sequential groups
    n_real = len(signals)
    S, m_max, max_b = _budget_geometry(signals, fs, fft_len)
    if n_real > max_b:
        out, rows, nms = [], [], []
        for i in range(0, n_real, max_b):
            group = signals[i:i + max_b]
            r = copy_synthesis_batch(group, fs, fft_len=fft_len,
                                     block_result=block_result, device=device)
            if block_result:
                out.extend(r)
            else:
                bufs_g, nm_g = r
                rows.extend(bufs_g[j] for j in range(len(group)))
                nms.extend(nm_g[j] for j in range(len(group)))
        return out if block_result else (rows, nms)

    # bucket the batch axis (silent dummy utterances, dropped on return)
    B = bucket(n_real, capped_batch_step(max_b))
    if B > n_real:
        signals = list(signals) + [np.zeros(1024)] * (B - n_real)
    sigs = np.zeros((B, S), np.float32)
    for b, s in enumerate(signals):
        sigs[b, :len(s)] = s
    n_sigs = np.asarray([len(s) for s in signals], np.int32)
    n_frames, Tmax = _tracker_frame_geometry(signals, fs)
    out_len_max = S + (1 << 14)

    bufs, n_marks, nm = _copy_synthesis_impl(
        *(torch.from_numpy(a).to(device) for a in (sigs, n_sigs, n_frames)),
        fs=fs, n_frames_max=Tmax, m_max=m_max, fft_len=fft_len,
        out_len_max=out_len_max)
    if int(nm[:n_real].max(initial=0)) >= m_max:
        logger.warning("copy-synthesis epoch-walk capacity hit; output "
                       "truncated for some utterance(s)")
    if not block_result:
        return bufs, n_marks
    bufs = bufs.cpu().numpy()
    return [bufs[b, :len(signals[b])].astype(np.float64)
            for b in range(n_real)]
