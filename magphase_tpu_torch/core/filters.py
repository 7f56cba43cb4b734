"""Filters (port of magphase_tpu/core/filters.py): the 3-point median
filter, the Butterworth and elliptic high-pass designs, lfilter as a
parallel prefix, and sosfilt as FFT convolution with the filter's exact
truncated impulse response (whole-signal or blocked overlap-save).

Filter design is host scipy float64, imported at first use, so that
importing the package stays cheap.  The filtering itself runs on the
device of the tensor it is given, along its last axis (rows of a batch
are filtered independently)."""
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
def ellip_highpass_coeffs(order: int, rp: float, rs: float, fc_hz: float,
                          fs: int):
    """Elliptic high-pass (b, a) — magphase.py:1415-1419 (0.5 dB / 80 dB)."""
    from scipy import signal as sp_signal
    b, a = sp_signal.ellip(order, rp, rs, fc_hz / (fs / 2.0),
                           btype="highpass")
    return tuple(b.tolist()), tuple(a.tolist())


def lfilter(b, a, x: torch.Tensor) -> torch.Tensor:
    """scipy.signal.lfilter(b, a, x) along the last axis, zero initial
    state, in x's dtype on x's device.

    Transposed Direct-Form-II (n = max(len(a), len(b)) - 1):
      y[t]    = b0*x[t] + z0[t]
      zi[t+1] = b_{i+1}*x[t] + z_{i+1}[t] - a_{i+1}*y[t]
    is affine in the state, z[t+1] = A z[t] + u x[t], and the prefix of
    those maps is composed by doubling (log2(T) steps of (T, n, n) matrix
    products), the parallel prefix the JAX package takes with
    lax.associative_scan.  As there, the prefix products overflow float32
    for poles near the unit circle (a 4th-order 40 Hz high-pass at
    48 kHz): use ``sosfilt`` for those."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = b / a[0]
    a = a / a[0]
    n = max(len(a), len(b)) - 1
    bp = np.zeros(n + 1)
    ap = np.zeros(n + 1)
    bp[:len(b)] = b
    ap[:len(a)] = a
    if n == 0:
        return float(bp[0]) * x

    A = np.zeros((n, n))
    A[:, 0] = -ap[1:]
    A[:-1, 1:] += np.eye(n - 1)
    u = bp[1:] - ap[1:] * bp[0]

    T = x.shape[-1]
    As = torch.tensor(A, dtype=x.dtype, device=x.device).expand(T, n, n)
    bs = torch.tensor(u, dtype=x.dtype, device=x.device) * x[..., None]
    d = 1
    while d < T:
        # element t becomes (element t) after (element t - d)
        bs = torch.cat([bs[..., :d, :], bs[..., d:, :] + torch.einsum(
            "tij,...tj->...ti", As[d:], bs[..., :-d, :])], dim=-2)
        As = torch.cat([As[:d], As[d:] @ As[:-d]], dim=0)
        d *= 2
    # z[t], the state before x[t], is the prefix up to t-1 applied to 0
    z0 = torch.cat([torch.zeros_like(x[..., :1]), bs[..., :-1, 0]], dim=-1)
    return float(bp[0]) * x + z0


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


@functools.lru_cache(maxsize=16)
def _sos_impulse_response(sos, ntaps: int) -> np.ndarray:
    """Exact (float64, scipy) impulse response of the SOS cascade,
    truncated to ``ntaps``."""
    from scipy import signal as sp_signal
    imp = np.zeros(ntaps)
    imp[0] = 1.0
    return sp_signal.sosfilt(np.asarray(sos, np.float64), imp)


@functools.lru_cache(maxsize=16)
def _sos_ir_trimmed(sos, ntaps: int) -> np.ndarray:
    """The impulse response trimmed where it has decayed below 1e-8 of its
    peak, rounded up to a multiple of 1024 samples."""
    h = _sos_impulse_response(sos, ntaps)
    peak = np.abs(h).max()
    sig = np.nonzero(np.abs(h) > 1e-8 * peak)[0]
    m = int(sig[-1]) + 1 if sig.size else 1
    m = min(ntaps, -(-m // 1024) * 1024)
    return h[:m]


# rows per FFT call of the blocked sections on the CPU: one, since MKL's
# result for a row of a batched call depends on the row's place in it
_CPU_ROWS = 1


def blocked_section_len(m: int) -> int:
    """The FFT length of ``sosfilt(mode='blocked')`` for an impulse
    response of m taps: 1 << ceil(log2(max(4m, 32768))), independent of the
    signal's length."""
    return 1 << int(np.ceil(np.log2(max(4 * m, 32768))))


def _filter_spectrum(h: np.ndarray, nfft: int, like: torch.Tensor):
    """rfft of h at nfft points (float64 on the host), cast to the complex
    type of ``like`` on its device."""
    cdtype = torch.complex64 if like.dtype == torch.float32 else \
        torch.complex128
    return torch.from_numpy(np.fft.rfft(h, n=nfft)).to(like.device, cdtype)


def sosfilt(sos, x: torch.Tensor, ntaps: int = 16384,
            mode: str = "auto") -> torch.Tensor:
    """Cascaded-biquad IIR filter (scipy.signal.sosfilt semantics, zero
    initial state) along the last axis of x, as FFT convolution with the
    exact impulse response trimmed by _sos_ir_trimmed (the float32 state
    recursion of a high-pass with poles near the unit circle is unstable;
    the dropped tail sums to about 4e-6 of the response).

    ``mode='auto'`` takes one whole-signal rfft.irfft or overlap-save
    blocks, whichever needs fewer FFT points, as the JAX package does.
    ``mode='blocked'`` always takes overlap-save, with sections of
    blocked_section_len(m) samples whatever the signal's length: output
    sample i then depends only on x[..., :i+1] and the fixed block grid,
    never on how far the row was padded, so each utterance of a batch is
    filtered as it would be alone.  The blocked sections' FFTs run in
    calls of a fixed row count (spectral.rows_fft; _CPU_ROWS on the CPU)
    for the same reason.  The JAX package's MAGPHASE_HPF_BLOCK sweep of the
    section size is not ported."""
    from .spectral import rows_fft
    if mode not in ("auto", "blocked"):
        raise ValueError(f"sosfilt mode={mode!r}: 'auto' or 'blocked'")
    n = x.shape[-1]
    h = _sos_ir_trimmed(tuple(map(tuple, sos)), ntaps)
    m = len(h)
    if mode == "blocked":
        nblk = blocked_section_len(m)
    else:
        nblk = 1 << int(np.ceil(np.log2(max(4 * m, min(n + m, 32768)))))
    L = nblk - (m - 1)
    nblocks = -(-n // L)
    whole_pts = 1 << int(np.ceil(np.log2(n + m)))
    if mode != "blocked" and whole_pts <= 1.1 * nblocks * nblk:
        X = torch.fft.rfft(x, n=whole_pts)
        H = _filter_spectrum(h, whole_pts, x)
        return torch.fft.irfft(X * H, n=whole_pts)[..., :n].to(x.dtype)
    ph = m - 1
    lead = x.shape[:-1]
    xp = torch.cat([x.new_zeros(lead + (ph,)), x,
                    x.new_zeros(lead + (nblocks * L + nblk,))], dim=-1)
    idx = (torch.arange(nblocks, device=x.device) * L)[:, None] + \
        torch.arange(nblk, device=x.device)[None, :]
    X = rows_fft(torch.fft.rfft, xp[..., idx], cpu_rows=_CPU_ROWS, n=nblk)
    H = _filter_spectrum(h, nblk, x)
    # the product in real arithmetic: the CPU's vectorised complex multiply
    # rounds an element by where it falls in the tensor
    xr, xi, hr, hi = X.real, X.imag, H.real, H.imag
    X = torch.complex(xr * hr - xi * hi, xr * hi + xi * hr)
    y = rows_fft(torch.fft.irfft, X, cpu_rows=_CPU_ROWS, n=nblk)[..., ph:]
    return y.reshape(lead + (-1,))[..., :n].to(x.dtype)
