"""Mel-cepstral transforms: the forward mel warp of compressed analysis and
the unwarp of synthesis (port of magphase_tpu/core/melcep.py).

The SPTK tools the reference shells out to are linear maps here: host
float64 matrices built once per (size, alpha), applied as float32 matmuls.
The matmuls must run in full float32 — TF32 keeps ~3 decimal digits and
moves the mel-unwarped spectra by ~1e-3 — so ``mm`` refuses to run on a
card where TF32 matmuls are switched on.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .spectral import add_hermitian_half, mel_curve_np


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32-accurate matmul (cuBLAS on the card, without TF32)."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul."
            "allow_tf32); the mel transforms need full float32")
    return torch.matmul(a, b)


@functools.lru_cache(maxsize=32)
def freqt_matrix_np(m1: int, m2: int, alpha: float) -> np.ndarray:
    """(m1+1, m2+1) matrix F with freqt(c)[k] = sum_m c[m] * F[m, k]
    (SPTK freqt, _freqt.c): row m is the order-<=m2 expansion of Psi^m,
    Psi(z~) = (z~^-1 + alpha)/(1 + alpha z~^-1)."""
    F = np.zeros((m1 + 1, m2 + 1))
    F[0, 0] = 1.0
    row = F[0].copy()
    for m in range(1, m1 + 1):
        new = np.empty(m2 + 1)
        # g[k] = f[k-1] + alpha*f[k] - alpha*g[k-1];  g[0] = alpha*f[0]
        new[0] = alpha * row[0]
        for k in range(1, m2 + 1):
            new[k] = row[k - 1] + alpha * (row[k] - new[k - 1])
        F[m] = new
        row = new
    return F


def _const(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def freqt(m_ceps: torch.Tensor, m2: int, alpha: float) -> torch.Tensor:
    """Batched frequency transform: (rows, m1+1) -> (rows, m2+1)."""
    m1 = m_ceps.shape[-1] - 1
    return mm(m_ceps, _const(freqt_matrix_np(m1, m2, alpha), m_ceps))


@functools.lru_cache(maxsize=32)
def cosmat_np(n_cepcoeffs: int, n_spbins: int, alpha: float) -> np.ndarray:
    """(n_cepcoeffs, n_spbins) matrix  C[k, i] = cos(k * beta_i)  with beta
    the warped frequency of output bin i (libaudio.py:605-619)."""
    v_warp = mel_curve_np(alpha, n_spbins) if alpha != 0.0 else \
        np.linspace(0, np.pi, n_spbins)
    k = np.arange(n_cepcoeffs)[:, None]
    return np.cos(k * v_warp[None, :])


def mcep_to_sp_cosmat(m_mcep: torch.Tensor, n_spbins: int,
                      alpha: float = 0.77, out_type: str = "abs",
                      cosmat: torch.Tensor | None = None) -> torch.Tensor:
    """mcep -> spectrum via cosine matrix (libaudio.py:605-631).
    ``cosmat``: the float32 (ncoeffs, n_spbins) matrix on m_mcep's device,
    when the caller holds it already (SynthesisTables)."""
    if cosmat is None:
        cosmat = _const(cosmat_np(m_mcep.shape[-1], n_spbins, alpha), m_mcep)
    m_sp = mm(m_mcep, cosmat)
    if out_type == "abs":
        return torch.exp(m_sp)
    if out_type == "db":
        return m_sp * (20.0 / np.log(10.0))
    if out_type == "log":
        return m_sp
    raise ValueError(out_type)


@functools.lru_cache(maxsize=32)
def mcep_matrix_np(f2: int, fft_len: int, n_coeffs: int,
                   alpha: float) -> np.ndarray:
    """(f2+1, n_coeffs) float32 matrix M with mcep = log_periodogram @ M.

    SPTK ``mcep -j 0`` (zero Newton iterations, libaudio.py:575-601) is its
    initial estimate: freqt of the one-sided cepstrum of the log
    periodogram.  Everything after the log is linear, so the cepstrum
    (hermitian fold weights times cosines), the halving at t in {0, f2} and
    the freqt matrix compose in float64 into one matrix."""
    k = np.arange(f2 + 1, dtype=np.float64)
    t = np.arange(f2 + 1, dtype=np.float64)
    w = np.full(f2 + 1, 2.0 / fft_len)
    w[0] = 1.0 / fft_len
    if 2 * f2 == fft_len:
        w[f2] = 1.0 / fft_len
    A = w[:, None] * np.cos(2.0 * np.pi * np.outer(k, t) / fft_len)
    A[:, 0] *= 0.5                      # one-sided cepstrum halving
    A[:, f2] *= 0.5
    F = freqt_matrix_np(f2, n_coeffs - 1, alpha)
    return (A @ F).astype(np.float32)


def sp_to_mcep(m_sp: torch.Tensor, n_coeffs: int = 60, alpha: float = 0.77,
               in_type: int = 3, fft_len: int = 0,
               eps: float = 1.0e-8) -> torch.Tensor:
    """Spectrum -> mel-cepstrum with the semantics of ``mcep -a alpha
    -m n_coeffs-1 -l fft_len -e 1e-8 -j 0 -f 0.0 -q in_type``
    (libaudio.py:575-601), as one matmul of the log periodogram.

    in_type: 3 => |f(w)|, 1 => 20log10|f(w)|, 2 => ln|f(w)|.
    m_sp: (rows, fft_len/2+1) non-redundant spectrum."""
    f2 = m_sp.shape[-1] - 1
    if fft_len == 0:
        fft_len = 2 * f2
    if in_type == 3:
        amp2 = m_sp * m_sp
    elif in_type == 1:
        amp = torch.pow(10.0, m_sp / 20.0)
        amp2 = amp * amp
    elif in_type == 2:
        amp = torch.exp(m_sp)
        amp2 = amp * amp
    else:
        raise ValueError(f"in_type {in_type} not supported")
    P = torch.log(amp2 + eps)                        # log periodogram
    return mm(P, _const(mcep_matrix_np(f2, fft_len, n_coeffs, alpha), P))


def sp_mel_warp(m_sp: torch.Tensor, nbins_out: int, alpha: float = 0.77,
                in_type: int = 3) -> torch.Tensor:
    """Compression: spectrum -> mcep(alpha) -> sampled on the uniform
    warped grid (libaudio.py:643-661)."""
    m_mcep = sp_to_mcep(m_sp, n_coeffs=nbins_out, alpha=alpha,
                        in_type=in_type)
    out_type = {3: "abs", 1: "db", 2: "log"}[in_type]
    return mcep_to_sp_cosmat(m_mcep, nbins_out, alpha=0.0, out_type=out_type)


def sp_mel_unwarp(m_sp_mel: torch.Tensor, nbins_out: int,
                  alpha: float = 0.77, in_type: str = "log",
                  cosmat: torch.Tensor | None = None) -> torch.Tensor:
    """Decompression: mel spectrum -> compact cepstrum -> warped cosine
    evaluation at nbins_out linear bins (libaudio.py:667-684), with the
    reference's doubling range [1:ncoeffs-2] kept for parity."""
    ncoeffs = m_sp_mel.shape[-1]
    if in_type == "abs":
        m_sp_mel = torch.log(m_sp_mel)
    m_mcep = torch.fft.ifft(add_hermitian_half(m_sp_mel)).real
    scale = torch.ones(m_mcep.shape[-1], dtype=m_mcep.dtype,
                       device=m_mcep.device)
    scale[1:ncoeffs - 2] = 2.0
    m_mcep = (m_mcep * scale)[..., :ncoeffs]
    return mcep_to_sp_cosmat(m_mcep, nbins_out, alpha=alpha,
                             out_type=in_type, cosmat=cosmat)


def mc2b(m_mc: torch.Tensor, alpha: float) -> torch.Tensor:
    """mel-cepstrum -> MLSA filter coefficients b (SPTK mc2b):
    b[m] = sum_{j>=m} (-alpha)^(j-m) c[j], as one matmul."""
    M = m_mc.shape[-1] - 1
    j = np.arange(M + 1)
    T = np.where(j[None, :] >= j[:, None],
                 (-alpha) ** (j[None, :] - j[:, None]), 0.0)
    return mm(m_mc, _const(T.T, m_mc))


def b2mc(m_b: torch.Tensor, alpha: float) -> torch.Tensor:
    """MLSA b -> mel-cepstrum (SPTK b2mc): c[m] = b[m] + alpha*b[m+1]."""
    up = torch.cat([m_b[..., 1:], torch.zeros_like(m_b[..., :1])], dim=-1)
    return m_b + alpha * up


def c2acr_r0(m_ceps: torch.Tensor, fft_len: int) -> torch.Tensor:
    """Zeroth autocorrelation from a (one-sided) cepstrum (SPTK
    ``c2acr -M 0 -l fft_len``): r0 = mean over bins of exp(2*Re C(w))."""
    spec = torch.fft.rfft(m_ceps, n=fft_len).real
    P_half = torch.exp(2.0 * spec)
    w = torch.ones(fft_len // 2 + 1, dtype=m_ceps.dtype, device=m_ceps.device)
    w[1:-1] = 2.0
    return torch.sum(P_half * w, dim=-1) / fft_len
