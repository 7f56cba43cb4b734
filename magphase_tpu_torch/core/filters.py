"""The 3-point median filter and the 40 Hz output high-pass, as (b, a) for
the host IIR of single-utterance synthesis and in its spectral form for
the batched paths (port of that subset of magphase_tpu/core/filters.py).  Filter
design is host scipy float64, imported at first use, so that importing
the package stays cheap."""
from __future__ import annotations

import functools

import numpy as np
import torch


def medfilt3(v: torch.Tensor) -> torch.Tensor:
    """scipy.signal.medfilt(v) with kernel_size=3 (zero padding) along the
    last axis, as a min/max network."""
    zero = torch.zeros_like(v[..., :1])
    a = torch.cat([zero, v[..., :-1]], dim=-1)
    c = torch.cat([v[..., 1:], zero], dim=-1)
    return torch.maximum(torch.minimum(a, v),
                         torch.minimum(torch.maximum(a, v), c))


@functools.lru_cache(maxsize=16)
def butter_highpass_coeffs(order: int, fc_hz: float, fs: int):
    """Butterworth high-pass (b, a) — magphase.py:990-995."""
    from scipy import signal as sp_signal
    b, a = sp_signal.butter(order, fc_hz / (fs / 2.0), btype="highpass")
    return tuple(b.tolist()), tuple(a.tolist())


@functools.lru_cache(maxsize=16)
def butter_highpass_sos(order: int, fc_hz: float, fs: int):
    """Butterworth high-pass as second-order sections (the 40 Hz output
    filter of magphase.py:990-995)."""
    from scipy import signal as sp_signal
    sos = sp_signal.butter(order, fc_hz / (fs / 2.0), btype="highpass",
                           output="sos")
    return tuple(map(tuple, sos.tolist()))


@functools.lru_cache(maxsize=16)
def sos_freq_response_rfft(sos, fft_len: int):
    """Exact steady-state frequency response of the SOS cascade at the
    ``fft_len`` rfft bin frequencies, as two float32 vectors (re, im) —
    the per-bin gain the synthesis applies to every frame spectrum
    (MAGPHASE_HPF_MODE=spectral)."""
    from scipy import signal as sp_signal
    w = 2.0 * np.pi * np.arange(fft_len // 2 + 1) / float(fft_len)
    _, H = sp_signal.sosfreqz(np.asarray(sos, np.float64), worN=w)
    return H.real.astype(np.float32), H.imag.astype(np.float32)
