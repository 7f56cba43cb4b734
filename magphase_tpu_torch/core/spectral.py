"""Spectral-domain primitives (port of magphase_tpu/core/spectral.py),
batched over the leading axes: each acts on the last axis of its tensor,
on the tensor's device.

Also the row-batched FFT helper of the synthesis paths (``rows_fft``):
on the card it runs a transform in calls of a fixed row count, so that a
row's result does not depend on how many rows share the call."""
from __future__ import annotations

import functools

import numpy as np
import torch

MAGIC = -1.0e10  # SPTK log floor (libaudio.py:17)


def protected_log(m_x: torch.Tensor) -> torch.Tensor:
    """Protected log: inf/nan -> MAGIC (libaudio.py:241-248)."""
    m_y = torch.log(m_x)
    return torch.where(torch.isfinite(m_y), m_y, MAGIC)


def protected_log_np(m_x: np.ndarray) -> np.ndarray:
    """Host-side protected log (libaudio.py:241-248)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        m_y = np.log(m_x)
    m_y[~np.isfinite(m_y)] = MAGIC
    return m_y


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


def add_hermitian_half(m_data: torch.Tensor,
                       data_type: str = "mag") -> torch.Tensor:
    """Mirror a non-redundant half spectrum (libaudio.py:369-388) along the
    last axis.  'mag'/'magnitude': [x0 .. x_{h-1}, x_{h-2} .. x1];
    'phase': the odd mirror, DC and Nyquist zeroed; 'zeros': h-2 zeros
    appended; 'complex': 'mag' on the real part, 'phase' on the
    imaginary part."""
    if data_type in ("mag", "magnitude"):
        return torch.cat([m_data, torch.flip(m_data[..., 1:-1], dims=[-1])],
                         dim=-1)
    if data_type == "phase":
        m = m_data.clone()
        m[..., 0] = 0
        m[..., -1] = 0
        return torch.cat([m, -torch.flip(m[..., 1:-1], dims=[-1])], dim=-1)
    if data_type == "zeros":
        return torch.cat([m_data, m_data.new_zeros(
            m_data.shape[:-1] + (m_data.shape[-1] - 2,))], dim=-1)
    if data_type == "complex":
        return torch.complex(add_hermitian_half(m_data.real),
                             add_hermitian_half(m_data.imag, "phase"))
    raise ValueError(data_type)


def remove_hermitian_half(m_data: torch.Tensor) -> torch.Tensor:
    """Keep floor(N/2)+1 bins of the last axis (libaudio.py:392-399)."""
    return m_data[..., :m_data.shape[-1] // 2 + 1]


def spectral_crossfade(m_sp_l: torch.Tensor, m_sp_r: torch.Tensor,
                       cut_off: float, bw: float, fs: int) -> torch.Tensor:
    """Crossfade two half spectra around cut_off (libaudio.py:160-186):
    m_sp_l * w + m_sp_r * (1 - w) with w = crossfade_down_win_np."""
    h = m_sp_l.shape[-1]
    w = torch.tensor(crossfade_down_win_np(cut_off, bw, fs, h),
                     dtype=m_sp_l.real.dtype, device=m_sp_l.device)
    return m_sp_l * w + m_sp_r * (1.0 - w)


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


def rceps_to_min_phase_rceps(m_rceps: torch.Tensor) -> torch.Tensor:
    """Cepstral folding (libaudio.py:190-197): the first N/2+1
    coefficients, the interior ones doubled."""
    n = m_rceps.shape[-1]
    h = n // 2 + 1
    scale = torch.ones(n, dtype=m_rceps.dtype, device=m_rceps.device)
    scale[1:h - 1] = 2.0
    return (m_rceps * scale)[..., :h]


@functools.lru_cache(maxsize=16)
def _lifter_np(h: int, nc_total: int, nc_fade: int) -> np.ndarray:
    """The cepstral lifter of spectral_smoothing_rceps: ones up to
    nc_total - nc_fade, a hanning fade to nc_total, zeros after."""
    v_win = np.hanning(2 * nc_fade + 3)[nc_fade + 2:-1]
    mask = np.ones(h)
    mask[nc_total:] = 0.0
    mask[nc_total - nc_fade:nc_total] = v_win
    return mask


def spectral_smoothing_rceps(m_sp_log: torch.Tensor, nc_total: int = 60,
                             fade_to_total: float = 0.2) -> torch.Tensor:
    """Cepstral liftering smoother (libaudio.py:203-238): the folded real
    cepstrum of the log spectrum, liftered to nc_total coefficients with a
    fade, back to the spectrum."""
    nc_fade = int(round(fade_to_total * nc_total))
    m_full = add_hermitian_half(m_sp_log)
    n = m_full.shape[-1]
    h = n // 2 + 1
    m_minph = rceps_to_min_phase_rceps(torch.fft.ifft(m_full).real)
    mask = torch.tensor(_lifter_np(h, nc_total, nc_fade),
                        dtype=m_minph.dtype, device=m_minph.device)
    m_minph = m_minph * mask
    m_padded = torch.cat([m_minph, m_minph.new_zeros(
        m_minph.shape[:-1] + (n - h,))], dim=-1)
    return torch.fft.fft(m_padded).real[..., :m_sp_log.shape[-1]]


def true_envelope(m_sp: torch.Tensor, in_type: str = "abs",
                  ncoeffs: int = 60, thres_db: float = 0.1,
                  n_maxiter: int = 100) -> torch.Tensor:
    """Iterative true-envelope estimator (libaudio.py:295-340) over the
    rows (frames) of m_sp, as the JAX package computes it: n_maxiter
    iterations for every frame, the reference's per-frame early exit as a
    freeze mask (a frame whose mean |spectrum - smoothed| in dB drops
    below thres_db keeps its spectrum from then on).  The result is the
    last iteration's smoothed spectrum."""
    return true_envelope_freeze(m_sp, in_type, ncoeffs, thres_db,
                                n_maxiter)[0]


def true_envelope_freeze(m_sp: torch.Tensor, in_type: str = "abs",
                         ncoeffs: int = 60, thres_db: float = 0.1,
                         n_maxiter: int = 100):
    """(true_envelope, the iteration at which each frame froze): the
    freeze iteration (n_maxiter for a frame that never froze) is the
    threshold decision that round-off can move between devices."""
    if in_type == "db":
        m_db = m_sp
    elif in_type == "abs":
        m_db = db(m_sp)
    elif in_type == "log":
        m_db = (20.0 / np.log(10.0)) * m_sp
    else:
        raise ValueError(in_type)

    done = torch.zeros(m_db.shape[:-1] + (1,), dtype=torch.bool,
                       device=m_db.device)
    frozen_at = torch.full(m_db.shape[:-1], n_maxiter, device=m_db.device)
    v_sp_db = m_db
    for i in range(n_maxiter):
        v_sm = spectral_smoothing_rceps(v_sp_db, nc_total=ncoeffs,
                                        fade_to_total=0.7)
        err = torch.mean(torch.abs(v_sp_db - v_sm), dim=-1, keepdim=True)
        newly = ~done & (err < thres_db)
        frozen_at = torch.where(newly[..., 0], i, frozen_at)
        done = done | newly
        v_sp_db = torch.where(done, v_sp_db, torch.maximum(v_sp_db, v_sm))
    if in_type == "abs":
        v_sm = db(v_sm, b_inv=True)
    elif in_type == "log":
        v_sm = (np.log(10.0) / 20.0) * v_sm
    return v_sm, frozen_at


def get_rms(m_data: torch.Tensor, nFFT: int) -> torch.Tensor:
    """Spectral-domain RMS of each row (libaudio.py:564-568)."""
    h = nFFT // 2
    scale = torch.ones(m_data.shape[-1], dtype=m_data.dtype,
                       device=m_data.device)
    scale[1:h] = 2.0
    return torch.sqrt(torch.sum((m_data ** 2 * scale)[..., :h + 1], dim=-1)
                      / nFFT)


# ---------------------------------------------------------------------------
# row-batched FFTs.  cuFFT picks its algorithm by the batch's row count,
# and below some count a row's transform differs in its last bits with the
# count (seen on the H100 for 2048-point transforms at 1,024-3,072 rows,
# not at 4,096-8,192): the synthesis FFTs run on the card in calls of
# exactly FFT_ROWS rows, so an utterance's samples do not depend on the
# batch around it.  The CPU's FFT (MKL) does the same for long transforms
# (32768 points: one row, 2-4 rows and 5 or more rows round differently,
# and so may a row's place in the call), so a caller that needs that
# independence there passes ``cpu_rows``.

FFT_ROWS = 4096


def rows_fft(fn, x: torch.Tensor, cpu_rows: int | None = None,
             **kw) -> torch.Tensor:
    """``fn`` (torch.fft.rfft or irfft) over the last axis of ``x``: on the
    card in calls of FFT_ROWS rows, on the CPU in calls of ``cpu_rows``
    rows when given, else in one call (fft_in_calls)."""
    per_call = FFT_ROWS if x.device.type == "cuda" else cpu_rows
    if per_call is None:
        return fn(x, **kw)
    y = fft_in_calls(fn, x.reshape(-1, x.shape[-1]), per_call, **kw)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def fft_in_calls(fn, rows: torch.Tensor, per_call: int,
                 **kw) -> torch.Tensor:
    """``fn`` over the (n, m) ``rows`` in calls of exactly ``per_call``
    rows, the last one padded with zero rows."""
    n = rows.shape[0]
    out = None
    for i in range(0, n, per_call):
        c = rows[i:i + per_call]
        if c.shape[0] < per_call:
            c = torch.cat([c, c.new_zeros(per_call - c.shape[0],
                                          c.shape[1])])
        y = fn(c, **kw)
        if out is None:
            out = y.new_empty(n, y.shape[-1])
        out[i:i + per_call] = y[:n - i]
    return out
