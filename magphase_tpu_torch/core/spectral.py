"""Spectral-domain primitives (port of the subset of
magphase_tpu/core/spectral.py that synthesis and compressed analysis use),
batched over the leading axes."""
from __future__ import annotations

import functools

import numpy as np
import torch

MAGIC = -1.0e10  # SPTK log floor (libaudio.py:17)


def protected_log(m_x: torch.Tensor) -> torch.Tensor:
    """Protected log: inf/nan -> MAGIC (libaudio.py:241-248)."""
    m_y = torch.log(m_x)
    return torch.where(torch.isfinite(m_y), m_y, MAGIC)


def f0_to_lf0(v_f0: torch.Tensor) -> torch.Tensor:
    """log with MAGIC floor at f0 <= 0 (libaudio.py:458-465)."""
    pos = v_f0 > 0
    return torch.where(pos, torch.log(torch.where(pos, v_f0, 1.0)), MAGIC)


def db(m_data, b_inv: bool = False):
    """20*log10 and inverse (libaudio.py:635-639)."""
    if not b_inv:
        return 20.0 * torch.log10(m_data)
    return 10.0 ** (m_data / 20.0)


@functools.lru_cache(maxsize=64)
def mel_curve_np(alpha: float, nbins: int,
                 amp: float = float(np.pi)) -> np.ndarray:
    """The alpha-warp frequency curve (libaudio.py:711-718), host-side.

    beta(omega) = arctan((1-a^2) sin w / ((1+a^2) cos w - 2a)), lifted into
    [0, pi] and scaled to ``amp``.
    """
    v_bins = np.linspace(0, np.pi, nbins)
    v_warp = np.arctan((1 - alpha ** 2) * np.sin(v_bins)
                       / ((1 + alpha ** 2) * np.cos(v_bins) - 2 * alpha))
    v_warp[v_warp < 0] += np.pi
    return v_warp * (amp / np.pi)


def build_mel_curve(alpha: float, nbins: int, amp: float = float(np.pi),
                    device=None) -> torch.Tensor:
    return torch.tensor(mel_curve_np(alpha, nbins, amp), dtype=torch.float32,
                        device=device)


@functools.lru_cache(maxsize=64)
def crossfade_down_win_np(cut_off: float, bw: float, fs: int,
                          fft_len_half: int) -> np.ndarray:
    """Left (fade-out) window of spectral_crossfade (libaudio.py:160-186):
    ones up to cut_off-bw/2, hanning half-fade to zero at cut_off+bw/2."""
    fft_len = (fft_len_half - 1) * 2
    bin_l = int(np.round((cut_off - bw / 2.0) * fft_len / float(fs)))
    bin_r = int(np.round((cut_off + bw / 2.0) * fft_len / float(fs)))
    bw_bin = bin_r - bin_l
    v_win = np.hanning(2 * bw_bin + 1)
    fade = v_win[bw_bin:]                      # 1 -> 0 over bw_bin+1 points
    return np.concatenate([np.ones(bin_l), fade,
                           np.zeros(fft_len_half - bin_r - 1)])


def add_hermitian_half(m_data: torch.Tensor) -> torch.Tensor:
    """Mirror a non-redundant half spectrum of magnitudes (libaudio.py:369-388,
    data_type='magnitude'): [x0 .. x_{h-1}, x_{h-2} .. x1]."""
    return torch.cat([m_data, torch.flip(m_data[..., 1:-1], dims=[-1])],
                     dim=-1)


def rceps(m_data: torch.Tensor, in_type: str = "log",
          out_type: str = "compact") -> torch.Tensor:
    """Real cepstrum of a half spectrum (libaudio.py:252-269), with the
    reference's exact doubling range m_rceps[:, 1:(ncoeffs-2)] *= 2."""
    ncoeffs = m_data.shape[-1]
    if in_type == "abs":
        m_data = protected_log(m_data)
    m_rceps = torch.fft.ifft(add_hermitian_half(m_data)).real
    if out_type == "compact":
        scale = torch.ones(m_rceps.shape[-1], dtype=torch.float32,
                           device=m_rceps.device)
        scale[1:ncoeffs - 2] = 2.0
        m_rceps = (m_rceps * scale)[..., :ncoeffs]
    return m_rceps


def build_min_phase_from_mag_spec(m_mag: torch.Tensor) -> torch.Tensor:
    """Minimum-phase complex spectrum via cepstral folding
    (libaudio.py:920-934).  m_mag (rows, h) -> (rows, h) complex."""
    h = m_mag.shape[-1]
    m_full = add_hermitian_half(protected_log(m_mag))
    m_ceps = torch.fft.ifft(m_full).real
    n = m_full.shape[-1]
    scale = torch.zeros(n, dtype=torch.float32, device=m_mag.device)
    scale[0] = 1.0
    scale[h - 1] = 1.0
    scale[1:h - 1] = 2.0
    m_cmplx = torch.fft.fft(m_ceps * scale)      # zero upper half, double mid
    return torch.exp(m_cmplx[..., :h])
