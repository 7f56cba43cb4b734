"""Pitch tracker and host epoch placer (port of
magphase_tpu/epochs/tracker.py), the replacement for the REAPER subprocess
of the reference (``reaper -s -x 400 -m 50 -a -u 0.005``,
libaudio.py:450-455).  Every device stage is batched over a leading
utterance axis:

  1. ``_preprocess`` - 80 Hz FIR high-pass + decimation to ~16 kHz, and an
     800 Hz low-passed copy for epoch snapping, as overlap-save FFT
     convolutions;
  2. ``_nccf``       - normalised cross-correlation per 5 ms frame over the
     lags of 50..400 Hz, all frames at once through rfft/irfft;
  3. ``_candidates`` - local maxima, the N_CAND best, parabolic lag refine;
  4. ``_viterbi``    - the (N_CAND+1)-state DP with octave-jump and voicing
     costs: its local costs and log2 lags in torch, then the DP in
     kernels/viterbi.py (one CUDA launch on the card, a Python loop over
     frames on the CPU).

Epoch placement follows in epochs/placement_device.py (kernel K4) or, for
one utterance on the host, ``place_epochs``.  The constants and FIR taps
are the JAX package's, bit for bit.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..kernels import viterbi as KV
# the JAX tracker's constants that the kernel modules hold
from ..kernels.viterbi import TRANS_W, VUV_COST
from ..kernels.walk import SNAP_HALF_ONSET, SNAP_HALF_RUN, SNAP_ONSET_MARKS
from ..utils.padding import bucket, bucket_signal

# tracker constants (REAPER flag parity: -x 400 -m 50 -u 0.005)
F0_MIN = 50.0
F0_MAX = 400.0
FRAME_STEP_S = 0.005
FS_ANALYSIS = 16000
CORR_WIN_S = 0.0075
N_CAND = 15

# DP costs (the transition costs VUV_COST and TRANS_W are the kernel's,
# kernels/viterbi.py)
UV_LOCAL = 0.35        # local cost of the unvoiced state
LAG_BIAS = 0.05        # slight preference for shorter lags (anti-octave)

_OS_BLOCK = 16384      # overlap-save FFT block


def analysis_rate(fs: int):
    """(fs_analysis, decimation): decimate by the integer factor landing
    closest to FS_ANALYSIS; the NCCF geometry follows the actual rate."""
    dec = max(1, int(round(fs / FS_ANALYSIS)))
    return fs / dec, dec


def frame_geometry(fs: int):
    """(step, w, max_lag, dec) of the NCCF frames at the analysis rate."""
    fs_a, dec = analysis_rate(fs)
    step = int(round(FRAME_STEP_S * fs_a))
    w = int(round(CORR_WIN_S * fs_a))
    max_lag = int(round(fs_a / F0_MIN))
    return step, w, max_lag, dec


def n_tracker_frames(n_sig: int, fs: int) -> int:
    """NCCF frames of an n_sig-sample signal (at least 1)."""
    step, w, max_lag, dec = frame_geometry(fs)
    return max(1, (n_sig // dec - (w + max_lag)) // step + 1)


@functools.lru_cache(maxsize=8)
def _fir_highpass(fc_hz: float, fs: int, taps: int = 255) -> np.ndarray:
    """Hann-windowed linear-phase high-pass (spectral inversion)."""
    n = np.arange(taps) - (taps - 1) / 2
    fc = fc_hz / fs
    lp = 2 * fc * np.sinc(2 * fc * n)
    lp *= np.hanning(taps)
    lp /= lp.sum()
    hp = -lp
    hp[(taps - 1) // 2] += 1.0
    return hp


@functools.lru_cache(maxsize=8)
def _fir_lowpass(fc_hz: float, fs: int, taps: int = 255) -> np.ndarray:
    n = np.arange(taps) - (taps - 1) / 2
    fc = fc_hz / fs
    lp = 2 * fc * np.sinc(2 * fc * n)
    lp *= np.hanning(taps)
    lp /= lp.sum()
    return lp


def nccf_whiten_mode() -> str:
    """MAGPHASE_TRACKER_WHITEN, validated: the segment pre-whitening before
    the correlation, 'none' (the default, raw NCCF), 'clipNN' (soft centre
    clipping at NN percent of the segment's peak) or 'cube'.  Any other
    value raises ValueError.  The JAX package measured neither clipping
    nor cubing to help (its tracker.py:nccf_whiten_mode); they are
    experiment knobs."""
    mode = os.environ.get("MAGPHASE_TRACKER_WHITEN", "none")
    if mode in ("none", "cube"):
        return mode
    if mode.startswith("clip"):
        try:
            float(mode[4:])
            return mode
        except ValueError:
            pass
    raise ValueError(f"MAGPHASE_TRACKER_WHITEN={mode!r}: expected 'none', "
                     "'clipNN' or 'cube'")


def _preprocess(sig: torch.Tensor, *, fs: int):
    """High-pass 80 Hz and decimate to the analysis rate; also the 800 Hz
    low-passed copy at the input rate for epoch snapping.  sig (B, n)
    float32 rows, padded (the mean is taken over the padded row, as the
    JAX package takes it).  Returns (xa (B, ceil(n/dec)), y_snap (B, n)).

    Overlap-save: block j's circular convolution outputs [ph, nblk) are
    the linear convolution's y[j*L, j*L+L), so the valid parts concatenate
    to the whole-signal convolution, sliced at each filter's delay.  The
    two filter spectra are built in float64 and cast to complex64."""
    x = sig - torch.mean(sig, dim=-1, keepdim=True)
    B, n = x.shape
    fs_a, dec = analysis_rate(fs)
    h_hp = _fir_highpass(80.0, fs)
    h_snap = _fir_lowpass(800.0, fs)
    taps = len(h_hp)
    h_a = np.convolve(h_hp, _fir_lowpass(0.45 * fs_a, fs)) if dec > 1 \
        else h_hp
    off_a = (len(h_a) - 1) // 2
    off_s = (taps - 1) // 2
    ph = len(h_a) - 1
    nblk = min(_OS_BLOCK, 1 << int(np.ceil(np.log2(n + 2 * ph))))
    L = nblk - ph
    nblocks = -(-(n + off_a) // L)
    xp = torch.cat([x.new_zeros(B, ph), x,
                    x.new_zeros(B, nblocks * L + nblk)], dim=1)
    idx = (torch.arange(nblocks, device=x.device) * L)[:, None] + \
        torch.arange(nblk, device=x.device)[None, :]
    X = torch.fft.rfft(xp[:, idx], n=nblk)
    Ha = torch.from_numpy(np.fft.rfft(h_a, n=nblk).astype(np.complex64))
    Hs = torch.from_numpy(np.fft.rfft(h_snap, n=nblk).astype(np.complex64))
    ya = torch.fft.irfft(X * Ha.to(x.device), n=nblk)[..., ph:].reshape(B, -1)
    ys = torch.fft.irfft(X * Hs.to(x.device), n=nblk)[..., ph:].reshape(B, -1)
    xa = ya[:, off_a:off_a + n][:, ::dec]
    y_snap = ys[:, off_s:off_s + n]
    return xa, y_snap


def _nccf(xa: torch.Tensor, n_frames: torch.Tensor, *, n_frames_max: int,
          fs_a: float = FS_ANALYSIS, whiten: str = "none"):
    """NCCF of every frame: xa (B, na) analysis-rate rows, n_frames (B,).
    Returns (nccf (B, T, max_lag+1), valid (B, T)) with T = n_frames_max.

    The (T, seg_len) segment matrix is ceil(seg_len/step) shifted views of
    one (T+nj, step) reshape of the row (frame starts are step-aligned), as
    in the JAX package; the zero tail pad is read only by invalid frames."""
    step = int(round(FRAME_STEP_S * fs_a))
    w = int(round(CORR_WIN_S * fs_a))
    min_lag = int(fs_a / F0_MAX)
    max_lag = int(round(fs_a / F0_MIN))
    seg_len = w + max_lag
    nfft = 1 << int(np.ceil(np.log2(seg_len + 1)))
    B = xa.shape[0]
    T = n_frames_max
    dev = xa.device
    valid = torch.arange(T, device=dev)[None, :] < n_frames[:, None]

    nj = -(-seg_len // step)
    need = (T + nj) * step
    pad = max(0, need - xa.shape[1])
    xa_r = torch.cat([xa, xa.new_zeros(B, pad)], dim=1)[:, :need]
    xa_r = xa_r.reshape(B, -1, step)
    seg = torch.cat([xa_r[:, j:j + T] for j in range(nj)],
                    dim=2)[..., :seg_len]

    if whiten.startswith("clip"):
        # soft centre clipping per segment: the low-level samples (reverb
        # tail, formant ringing) leave the correlation, the glottal-pulse
        # peaks pass through
        c = float(whiten[4:]) / 100.0
        m = torch.amax(torch.abs(seg), dim=-1, keepdim=True)
        seg = torch.sign(seg) * torch.clamp(torch.abs(seg) - c * m, min=0.0)
    elif whiten == "cube":
        seg = seg * seg * seg
    elif whiten != "none":
        raise ValueError(f"unknown whiten mode {whiten!r}")

    a = torch.where(torch.arange(seg_len, device=dev) < w, seg, 0.0)
    A = torch.fft.rfft(a, n=nfft)
    Bs = torch.fft.rfft(seg, n=nfft)
    num = torch.fft.irfft(torch.conj(A) * Bs, n=nfft)[..., :max_lag + 1]

    s2 = torch.cumsum(seg * seg, dim=-1)
    s2 = torch.cat([torch.zeros_like(s2[..., :1]), s2], dim=-1)
    e0 = (s2[..., w] - s2[..., 0])[..., None]
    e_tau = s2[..., w:w + max_lag + 1] - s2[..., :max_lag + 1]
    nccf = num / torch.sqrt(e0 * e_tau + 1e-12)
    tau = torch.arange(max_lag + 1, device=dev)
    lag_ok = (tau >= min_lag) & (tau <= max_lag)
    return torch.where(lag_ok, nccf, -1.0), valid


def _candidates(nccf: torch.Tensor):
    """Local maxima -> the N_CAND best (values, parabolic-refined
    fractional lags), each (B, T, N_CAND).

    Non-peaks all score -2.0, so ties are common: a stable descending sort
    keeps tied lags in increasing order, which is what ``lax.top_k`` gives
    (``torch.topk`` orders ties otherwise)."""
    left = torch.cat([nccf[..., :1], nccf[..., :-1]], dim=-1)
    right = torch.cat([nccf[..., 1:], nccf[..., -1:]], dim=-1)
    is_peak = (nccf >= left) & (nccf > right)
    scores = torch.where(is_peak, nccf, -2.0)
    vals, lags = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, lags = vals[..., :N_CAND], lags[..., :N_CAND]
    l = torch.clamp(lags, 1, nccf.shape[-1] - 2)
    ym = torch.gather(left, -1, l)             # nccf[l-1]
    y0 = torch.gather(nccf, -1, l)
    yp = torch.gather(right, -1, l)            # nccf[l+1]
    denom = ym - 2 * y0 + yp
    frac = torch.where(torch.abs(denom) > 1e-9, 0.5 * (ym - yp) / denom, 0.0)
    frac = torch.clamp(frac, -0.5, 0.5)
    return vals, lags.to(torch.float32) + frac


def _dp_costs(vals: torch.Tensor, lags: torch.Tensor, valid: torch.Tensor,
              *, fs_a: float = FS_ANALYSIS):
    """The DP's inputs from the candidates vals/lags (B, T, K): the local
    costs (B, T, K+1), state K unvoiced, and the log2 lags (B, T, K+1),
    the unvoiced state's 0.  Padding frames (valid false) are forced
    unvoiced at no cost."""
    log_lag = torch.log2(torch.clamp(lags, min=1.0))
    max_lag = torch.full_like(lags, fs_a / F0_MIN)
    local_v = 1.0 - vals + LAG_BIAS * (lags / max_lag)
    local_v = torch.where(vals > -1.5, local_v, 1e6)
    local = torch.cat([local_v, torch.full_like(local_v[..., :1], UV_LOCAL)],
                      dim=-1)
    pad_cost = torch.cat([torch.full_like(local_v, 1e6),
                          torch.zeros_like(local_v[..., :1])], dim=-1)
    local = torch.where(valid[..., None], local, pad_cost)
    ll_all = torch.cat([log_lag, torch.zeros_like(log_lag[..., :1])], dim=-1)
    return local, ll_all


def _viterbi(vals: torch.Tensor, lags: torch.Tensor, valid: torch.Tensor, *,
             fs_a: float = FS_ANALYSIS) -> torch.Tensor:
    """(K+1)-state DP over frames, state K = unvoiced: vals/lags (B, T, K),
    valid (B, T).  Returns the best state path (B, T) int64.

    Over all T frames, padding frames included: they are forced unvoiced
    at no cost and transitions into them are free, so the voicing of the
    real frames does not depend on the padding.  The costs are formed in
    torch (``_dp_costs``), the DP is ``kernels.viterbi.viterbi``."""
    local, ll_all = _dp_costs(vals, lags, valid, fs_a=fs_a)
    return KV.viterbi(local, ll_all, valid)


def track_batch(sigs: torch.Tensor, n_frames: torch.Tensor, *, fs: int,
                n_frames_max: int):
    """preprocess -> NCCF -> candidates -> Viterbi for padded rows
    sigs (B, S).  Returns (states (B, T), lags (B, T, N_CAND),
    y_snap (B, S), valid (B, T))."""
    whiten = nccf_whiten_mode()
    fs_a = analysis_rate(fs)[0]
    xa, y_snap = _preprocess(sigs, fs=fs)
    nccf, valid = _nccf(xa, n_frames, n_frames_max=n_frames_max, fs_a=fs_a,
                        whiten=whiten)
    vals, lags = _candidates(nccf)
    states = _viterbi(vals, lags, valid, fs_a=fs_a)
    return states, lags, y_snap, valid


def f0_from_states(states: np.ndarray, lags: np.ndarray, fs: int):
    """(f0, voiced) of one utterance's first n_frames states (T,) and
    refined lags (T, N_CAND), on the host as the JAX package computes them:
    f0 = fs_a / the selected lag where voiced, else 0."""
    n = len(states)
    voiced = states < N_CAND
    lag_sel = np.where(voiced, lags[np.arange(n),
                                    np.clip(states, 0, N_CAND - 1)], 0.0)
    f0 = np.where(voiced & (lag_sel > 0),
                  analysis_rate(fs)[0] / np.maximum(lag_sel, 1.0), 0.0)
    return f0, voiced


def track_f0(v_sig: np.ndarray, fs: int, *, device="cuda"):
    """Full F0 track of one signal: (f0[T], voiced[T], frame_step_s,
    y_snap[n]) as numpy; f0 is 0 in unvoiced frames, and frame t covers
    time t*frame_step_s."""
    sig = np.asarray(v_sig, np.float32)
    row = np.zeros((1, bucket_signal(sig.shape[0])), np.float32)
    row[0, :len(sig)] = sig
    step, _, _, dec = frame_geometry(fs)
    n_frames = n_tracker_frames(len(v_sig), fs)
    states, lags, y_snap, _ = track_batch(
        torch.from_numpy(row).to(device),
        torch.tensor([n_frames], device=device), fs=fs,
        n_frames_max=bucket(n_frames, 128))
    f0, voiced = f0_from_states(states[0].cpu().numpy()[:n_frames],
                                lags[0].cpu().numpy()[:n_frames], fs)
    # actual frame spacing: round(FRAME_STEP_S*fs_a) analysis samples, i.e.
    # that times dec input samples (5.034 ms at 44.1 kHz)
    frame_step_s = step * dec / fs
    return f0, voiced, frame_step_s, y_snap[0].cpu().numpy()[:len(v_sig)]


def place_epochs(v_sig: np.ndarray, fs: int, f0: np.ndarray,
                 voiced: np.ndarray, y_snap: np.ndarray,
                 frame_step_s: float = FRAME_STEP_S):
    """Period-integrating epoch placement with trough snapping, on the host
    (the JAX package's ``place_epochs``, line for line).  Voiced marks
    advance by the local period, each snapped to the minimum of y_snap in a
    window of +-SNAP_HALF_ONSET of a period for the first SNAP_ONSET_MARKS
    marks of a run and +-SNAP_HALF_RUN after; unvoiced marks every 5 ms.
    Returns (mark times [s], voicing flags)."""
    n = len(v_sig)
    T = len(f0)
    step = frame_step_s * fs
    unv_step = int(round(0.005 * fs))

    def frame_of(t):
        return min(T - 1, max(0, int(t / step)))

    marks = []
    flags = []
    t = 0.0
    run_len = 0
    while t < n - 1:
        fr = frame_of(t)
        if voiced[fr] and f0[fr] > 0:
            period = fs / f0[fr]
            half = (SNAP_HALF_ONSET if run_len < SNAP_ONSET_MARKS
                    else SNAP_HALF_RUN)
            lo = int(max(0, t + (1.0 - half) * period))
            hi = int(min(n - 1, t + (1.0 + half) * period))
            if hi <= lo + 1:
                break
            nxt = lo + int(np.argmin(y_snap[lo:hi]))
            if marks and nxt <= marks[-1]:
                nxt = marks[-1] + max(1, int((1.0 - half) * period))
            marks.append(nxt)
            flags.append(1)
            t = float(nxt)
            run_len += 1
        else:
            nxt = int(t) + unv_step
            if nxt >= n - 1:
                break
            if marks and nxt <= marks[-1]:
                nxt = marks[-1] + 1
            marks.append(nxt)
            flags.append(0)
            t = float(nxt)
            run_len = 0

    marks = np.asarray(marks, np.float64)
    flags = np.asarray(flags, np.float64)
    keep = marks < (n - 1)
    return marks[keep] / fs, flags[keep]


def extract_epochs(v_sig: np.ndarray, fs: int, *, device="cuda"):
    """(pitch-mark times [s], voicing flags) of one signal, REAPER-style:
    the tracker on ``device``, then the host walk."""
    f0, voiced, fstep, y_snap = track_f0(v_sig, fs, device=device)
    return place_epochs(v_sig, fs, f0, voiced, y_snap, fstep)
