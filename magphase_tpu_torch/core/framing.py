"""Pitch-synchronous framing and overlap-add, batched (port of
magphase_tpu/core/framing.py).

Frame layout contract (identical for analysis and synthesis): frame f
covers signal samples [pm[f-1], pm[f+1]] (pm[-1]:=0, pm[nfrms]:=n_sig-1),
L[f]=pm[f]-pm[f-1], R[f]=pm[f+1]-pm[f]; after delay compensation the pitch
mark sits at index 0 of the fft_len-wide frame and the tail wraps to the
end; after irfft+fftshift in synthesis the pitch mark sits at index
fft_len//2 and OLA places that index at pm[f] (magphase.py:55-60).

The frame gather and the overlap-add are kernels K1-K3
(kernels/framing.py), which dispatch by tensor device: the plain torch
version on the CPU, the CUDA kernel on the card.  The single-utterance
forms (frame_geometry, pitch_sync_frames, ola_centered) are batches of one
through the batched entries, so they reach the same kernels.
"""
from __future__ import annotations

import torch

from ..kernels import framing as K
from . import windows as W


def frame_geometry_batch(pm: torch.Tensor, nfrms: torch.Tensor,
                         n_sig: torch.Tensor):
    """Per-frame (left_lim, L, R, valid) from padded pitch marks (B, F)
    (the pm extension of magphase.py:81: prepend 0, append n_sig-1)."""
    B, F = pm.shape
    f = torch.arange(F, device=pm.device)[None, :]
    pm_prev = torch.where(f == 0, 0, torch.roll(pm, 1, dims=1))
    pm_next = torch.where(f >= nfrms[:, None] - 1, n_sig[:, None] - 1,
                          torch.roll(pm, -1, dims=1))
    valid = f < nfrms[:, None]
    L = torch.where(valid, pm - pm_prev, 0)
    R = torch.where(valid, pm_next - pm, 0)
    return pm_prev, L, R, valid


def pitch_sync_frames_batch(sig: torch.Tensor, pm: torch.Tensor,
                            nfrms: torch.Tensor, n_sig: torch.Tensor,
                            fft_len: int, win_family: int = W.HANNING,
                            voiced: torch.Tensor | None = None,
                            win_family_unvoiced: int | None = None):
    """Windowed, delay-compensated, zero-padded frames (magphase.py:291-323)
    through kernel K1: sig (B, S), pm/voiced (B, F), nfrms/n_sig (B,).

    With ``voiced`` and ``win_family_unvoiced`` the window family is chosen
    per frame (noise windowing, magphase.py:886-892).
    Returns (frames (B, F, fft_len), L, R, valid)."""
    B, S = sig.shape
    pm = torch.clamp(pm, 0, S - 1)
    _, L, R, valid = frame_geometry_batch(pm, nfrms, n_sig)
    if voiced is not None and win_family_unvoiced is not None:
        voi, fam_u = voiced.to(torch.float32), win_family_unvoiced
    else:
        voi, fam_u = torch.zeros_like(pm, dtype=torch.float32), win_family
    i32 = torch.int32
    frames = K.frames(sig.to(torch.float32).contiguous(),
                      pm.to(i32).contiguous(), L.to(i32).contiguous(),
                      R.to(i32).contiguous(), voi.contiguous(),
                      nfrms.to(i32).contiguous(), n_sig.to(i32).contiguous(),
                      fft_len=fft_len, fam_voiced=win_family,
                      fam_unvoiced=fam_u)
    return frames, L, R, valid


def ar_winlens(shifts: torch.Tensor, nfrms: torch.Tensor):
    """(winlen_l, winlen_r) (B, F) of the anti-ringing window per frame.

    shifts: (B, F) frame shifts; the reference extends them as
    [s0, s..., s_last, s_last] and uses winlen_l = s[f]+s[f+1],
    winlen_r = s[f+2]+s[f+3] on the extended array (magphase.py:969-971).
    """
    F = shifts.shape[1]
    f = torch.arange(F, device=shifts.device)[None, :]
    last = torch.clamp(nfrms - 1, min=0)[:, None]

    def s_ext(i):  # ext: [s0, s0..s_{n-1}, s_{n-1}, s_{n-1}]
        j = torch.minimum(torch.clamp(i - 1, min=0), last)
        return torch.gather(shifts, 1, j.expand(shifts.shape[0], F))

    return s_ext(f) + s_ext(f + 1), s_ext(f + 2) + s_ext(f + 3)


def apply_anti_ringing(frames: torch.Tensor, shifts: torch.Tensor,
                       nfrms: torch.Tensor) -> torch.Tensor:
    """Per-frame centred raised-hanning anti-ringing window over a
    two-pitch-period support (magphase.py:968-973): frames (B, F, N)."""
    wl, wr = ar_winlens(shifts, nfrms)
    return frames * W.anti_ring_window(wl, wr, frames.shape[-1])


def ola_centered_batch(frames: torch.Tensor, pm: torch.Tensor,
                       nfrms: torch.Tensor, out_len_max: int,
                       ar_shifts: torch.Tensor | None = None) -> torch.Tensor:
    """Overlap-add with frame centre (index fft_len//2) placed at pm[f]
    (ola() of magphase.py:34-62): frames (B, F, N), pm (B, F) non-decreasing
    over the valid frames -> (B, out_len_max), samples outside dropped.

    ``ar_shifts`` (B, F): apply the anti-ringing window to each frame
    inside the OLA (kernel K3) instead of as a separate pass
    (``apply_anti_ringing`` then kernel K2)."""
    N = frames.shape[-1]
    i32 = torch.int32
    frames = frames.to(torch.float32).contiguous()
    starts = (pm - N // 2).to(i32).contiguous()
    nfrms = nfrms.to(i32).contiguous()
    if ar_shifts is None:
        return K.ola(frames, starts, nfrms, out_len=out_len_max)
    wl, wr = ar_winlens(ar_shifts, nfrms)
    return K.ola_anti_ring(frames, starts, nfrms, wl.to(i32).contiguous(),
                           wr.to(i32).contiguous(), out_len=out_len_max)


# ---------------------------------------------------------------------------
# single-utterance forms: batches of one, on ``device``

def _one(device, *arrays):
    """Each array, tensor or scalar as a (1, ...) tensor on ``device``."""
    return [torch.as_tensor(a, device=device)[None] for a in arrays]


def frame_geometry(pm, nfrms, n_sig, *, device="cuda"):
    """Per-frame (left_lim, L, R, valid) of one utterance's padded pitch
    marks pm (F,)."""
    return tuple(x[0] for x in frame_geometry_batch(
        *_one(device, pm, nfrms, n_sig)))


def pitch_sync_frames(sig, pm, nfrms, n_sig, fft_len: int,
                      win_family: int = W.HANNING, voiced=None,
                      win_family_unvoiced: int | None = None, *,
                      device="cuda"):
    """Windowed, delay-compensated frames (F, fft_len) of one utterance
    (magphase.py:291-323) through kernel K1.  Returns (frames, L, R,
    valid)."""
    sig, pm, nfrms, n_sig = _one(device, sig, pm, nfrms, n_sig)
    if voiced is not None:
        (voiced,) = _one(device, voiced)
    return tuple(x[0] for x in pitch_sync_frames_batch(
        sig, pm, nfrms, n_sig, fft_len, win_family, voiced,
        win_family_unvoiced))


def ola_centered(frames, pm, nfrms, out_len_max: int, *,
                 device="cuda") -> torch.Tensor:
    """Overlap-add of one utterance's frames (F, N) centred at pm (F,)
    (ola() of magphase.py:34-62) through kernel K2 -> (out_len_max,)."""
    return ola_centered_batch(*_one(device, frames, pm, nfrms),
                              out_len_max)[0]
