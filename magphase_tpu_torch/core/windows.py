"""Window functions as closed-form elementwise profiles (port of
magphase_tpu/core/windows.py).

An asymmetric pitch-synchronous window of left length L and right length R
(libaudio.py:70-84) has the closed form

    w[q] = h(q/L)            for q <= L     (left side)
    w[q] = h((L+R-q)/R)      for q >  L     (right side)

with h the half profile, so window values are computed on the fly from
(q, L, R) integer tensors.  These formulas are what the CUDA framing
kernels (csrc/framing.cu) evaluate in registers.

Window family ids:
    0 = hanning          (np.hanning)
    1 = voi_noise        (np.bartlett ** 2.5, magphase.py:67-68)
    2 = boxcar           (no window)
    3 = raised_hanning   (att-parameterised, magphase.py:25-31; att=1 == hanning)
"""
from __future__ import annotations

import math

import numpy as np
import torch

HANNING = 0
VOI_NOISE = 1
BOXCAR = 2
RAISED_HANNING = 3


def _half_profile(t: torch.Tensor, family: int,
                  att: float = 1.0) -> torch.Tensor:
    """h(t): half-window profile, t in [0, 1] measured edge -> peak."""
    if family == HANNING:
        return 0.5 - 0.5 * torch.cos(math.pi * t)
    if family == VOI_NOISE:
        # t^2.5 as t*t*sqrt(t), exactly the JAX package's form (a pow
        # would round differently)
        tc = torch.clamp(t, 0.0, 1.0)
        return tc * tc * torch.sqrt(tc)
    if family == BOXCAR:
        return torch.ones_like(t)
    if family == RAISED_HANNING:
        return (1.0 - att) + att * (0.5 - 0.5 * torch.cos(math.pi * t))
    raise ValueError(f"unknown window family {family}")


def asym_win_value(q: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                   family: int, att: float = 1.0) -> torch.Tensor:
    """Value of the asymmetric window at integer offset ``q`` in a frame with
    left length L and right length R (total length L+R+1, peak at q=L).
    For L == 0 the left part is win(1) == [1.0]; the same for R == 0."""
    q = q.to(torch.float32)
    Lf = L.to(torch.float32)
    Rf = R.to(torch.float32)
    t_left = torch.where(Lf > 0, q / torch.clamp(Lf, min=1.0), 1.0)
    t_right = torch.where(Rf > 0, (Lf + Rf - q) / torch.clamp(Rf, min=1.0),
                          1.0)
    t = torch.where(q <= Lf, t_left, t_right)
    return _half_profile(t, family, att)


def asym_win_value_select(q, L, R, voiced, fam_voiced: int,
                          fam_unvoiced: int, att: float = 1.0):
    """Per-frame window-family selection (noise windowing,
    magphase.py:886-892: bartlett^2.5 on voiced frames, hanning otherwise)."""
    wv = asym_win_value(q, L, R, fam_voiced, att)
    wu = asym_win_value(q, L, R, fam_unvoiced, att)
    return torch.where(voiced, wv, wu)


def centr_win_value(p: torch.Tensor, winlen_l: torch.Tensor,
                    winlen_r: torch.Tensor, totlen: int, family: int,
                    att: float = 1.0,
                    fill_bound: bool = False) -> torch.Tensor:
    """gen_centr_win (libaudio.py:90-103): the asymmetric window placed with
    its peak at floor(totlen/2); outside its support, 0 (or the window's
    first value when ``fill_bound``).  ``p`` indexes the frame [0, totlen)."""
    nx_cntr = totlen // 2
    q = p - (nx_cntr - winlen_l)
    inside = (q >= 0) & (q <= winlen_l + winlen_r)
    qc = torch.minimum(torch.clamp(q, min=0), winlen_l + winlen_r)
    w = asym_win_value(qc, winlen_l, winlen_r, family, att)
    if fill_bound:
        fill = asym_win_value(torch.zeros_like(q), winlen_l, winlen_r,
                              family, att)
    else:
        fill = torch.zeros_like(w)
    return torch.where(inside, w, fill)


def anti_ring_window(winlen_l: torch.Tensor, winlen_r: torch.Tensor,
                     totlen: int) -> torch.Tensor:
    """The anti-ringing window of magphase.py:968-973: ``centr_win_value(p,
    wl, wr, totlen, RAISED_HANNING, att=1.0, fill_bound=True)`` over the
    frame p in [0, totlen), in its specialised form.  At att=1 the profile
    is plain hanning, so the fill value h(t(q=0)) is 0 for wl > 0 and 1 for
    wl == 0 — a per-frame select instead of a per-element re-evaluation
    (bitwise equal to the generic form).
    wl, wr (..., F) -> (..., F, totlen)."""
    Lw = winlen_l[..., None]
    Rw = winlen_r[..., None]
    p = torch.arange(totlen, device=winlen_l.device)
    q = p - (totlen // 2 - Lw)
    w = asym_win_value(torch.minimum(torch.clamp(q, min=0), Lw + Rw), Lw, Rw,
                       RAISED_HANNING, att=1.0)
    inside = (q >= 0) & (q <= Lw + Rw)
    fill = torch.where(Lw > 0, 0.0, 1.0)
    return torch.where(inside, w, fill)


# ---------------------------------------------------------------------------
# numpy host forms (the filter-bank matrices of core/fbank.py and test
# oracles), bit for bit the JAX package's

def hanning_np(M: int) -> np.ndarray:
    return np.hanning(M)


def gen_non_symmetric_win_np(left_len: int, right_len: int,
                             win_func=np.hanning,
                             b_norm: bool = False) -> np.ndarray:
    """Host-side port of libaudio.py:70-84: the left half of
    win(2L+1) joined to the flipped right half of win(2R+1)."""
    v_left = win_func(1 + 2 * left_len)[:left_len + 1]
    v_right = np.flipud(win_func(1 + 2 * right_len)[:right_len + 1])
    v_win = np.hstack((v_left, v_right[1:]))
    if b_norm:
        v_win = v_win / np.sum(v_win)
    return v_win


def voi_noise_window_np(length: int) -> np.ndarray:
    return np.bartlett(length) ** 2.5
