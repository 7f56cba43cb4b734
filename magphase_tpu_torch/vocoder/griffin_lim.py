"""Pitch-synchronous Griffin-Lim (port of magphase_tpu/vocoder/griffin_lim.py,
magphase.py:3320-3373).

Each iteration synthesises the signal from the magnitude and the current
phase (complex full-spectrum ifft, then the centred overlap-add, kernel
K2), re-analyses it (Hanning pitch-synchronous frames, kernel K1) and
keeps the phase of the re-analysed frames.  The reference keeps frames
centred (pitch mark at fft_len/2) with no delay compensation on either
side of the loop; that centred layout is the K1 layout rolled by
fft_len/2.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import framing
from ..core.spectral import add_hermitian_half, build_min_phase_from_mag_spec
from ..core.windows import HANNING
from ..utils.keys import prng_key, uniform_tensor
from ..utils.padding import FRM_STEP, bucket, bucket_signal, pad_to

PHASE_INITS = ("random", "linear", "min_phase", "given")


def initial_phase(m_mag_half: torch.Tensor, key, m_phase0: torch.Tensor,
                  phase_init: str, fft_len: int) -> torch.Tensor:
    """The (F, fft_len) full-spectrum phase the loop starts from
    (magphase.py:3340-3351): uniform in [-pi, pi) drawn from ``key`` at the
    padded shape, the phase of a centred impulse, the minimum phase of the
    magnitude, or the given half phase ``m_phase0``, odd-mirrored."""
    F = m_mag_half.shape[0]
    dev = m_mag_half.device
    if phase_init == "random":
        return 2 * np.pi * (uniform_tensor(key, (F, fft_len), device=dev)
                            - 0.5)
    if phase_init == "linear":
        imp = torch.zeros(F, fft_len, device=dev)
        imp[:, fft_len // 2] = 1.0
        return torch.angle(torch.fft.fft(imp))
    if phase_init == "min_phase":
        return add_hermitian_half(torch.angle(
            build_min_phase_from_mag_spec(m_mag_half)), "phase")
    if phase_init == "given":
        return add_hermitian_half(m_phase0.to(m_mag_half.dtype), "phase")
    raise ValueError(phase_init)


def griffin_lim_core(m_mag_half: torch.Tensor, pm: torch.Tensor, nfrms: int,
                     key, m_phase0: torch.Tensor, *, fft_len: int,
                     niters: int, out_len_max: int, phase_init: str):
    """One utterance on its device: m_mag_half/m_phase0 (F, h) float32,
    pm (F,) int pitch marks padded to F rows.  Returns (signal buffer
    (out_len_max,), half phase (F, h)).  m_phase0 is read only with
    phase_init='given' (the reference's ndarray init, magphase.py:3348)."""
    h = fft_len // 2 + 1
    m_mag = add_hermitian_half(m_mag_half)
    m_phase = initial_phase(m_mag_half, key, m_phase0, phase_init, fft_len)
    pm_b = pm[None]
    nfrms_b = torch.tensor([nfrms], device=pm.device)
    prev, last = pm[nfrms - 2:nfrms].tolist()
    n_sig = min(last + (last - prev) + 1, out_len_max)
    n_sig_b = torch.tensor([n_sig], device=pm.device)

    def synthesis(m_phase):
        # magphase.py:3357-3360: centred frames -> OLA (K2)
        frames = torch.fft.ifft(torch.polar(m_mag, m_phase)).real
        return framing.ola_centered_batch(frames[None], pm_b, nfrms_b,
                                          out_len_max)

    for _ in range(niters - 1):
        # re-analysis (3365-3371): pitch-synchronous Hanning frames (K1),
        # centred
        frames = framing.pitch_sync_frames_batch(
            synthesis(m_phase), pm_b, nfrms_b, n_sig_b, fft_len,
            win_family=HANNING)[0][0]
        m_phase = torch.angle(torch.fft.fft(
            torch.roll(frames, fft_len // 2, dims=1)))
    # the final synthesis with the last phase (the loop breaks before its
    # re-analysis)
    return synthesis(m_phase)[0], m_phase[:, :h]


def griffin_lim(m_mag, v_shift, phase_init="random", niters: int = 30,
                key=None, *, device="cuda"):
    """magphase.py:3320-3373: (v_sig, half phase matrix) as float64 numpy
    from the half magnitude (nfrms, h) and the frame shifts.

    phase_init: 'random' (drawn from ``key``, prng_key(0) when None) |
    'linear' | 'min_phase' | an (nfrms, h) array of initial phase values
    (magphase.py:3348-3349).  The loop runs on ``device``."""
    if key is None:
        key = prng_key(0)
    m_mag = np.asarray(m_mag, np.float64)
    v_shift = np.round(np.asarray(v_shift)).astype(np.int64)
    nfrms, h = m_mag.shape
    fft_len = 2 * (h - 1)
    v_pm = np.cumsum(v_shift)
    out_len = int(v_pm[-1] + (v_pm[-1] - v_pm[-2]) + 1)
    F = bucket(nfrms, FRM_STEP)
    O = bucket_signal(out_len)

    if isinstance(phase_init, str):
        m_phase0 = np.zeros((F, h), np.float32)
        init_mode = phase_init
    else:
        m_phase0 = pad_to(np.asarray(phase_init, np.float32), F)
        if m_phase0.shape != (F, h):
            raise ValueError("phase_init matrix must be (nfrms, h)")
        init_mode = "given"
    if init_mode not in PHASE_INITS:
        raise ValueError(phase_init)

    dev = torch.device(device)
    v_sig, m_phase = griffin_lim_core(
        torch.from_numpy(pad_to(m_mag.astype(np.float32), F)).to(dev),
        torch.from_numpy(pad_to(v_pm.astype(np.int32), F)).to(dev), nfrms,
        key, torch.from_numpy(m_phase0).to(dev), fft_len=fft_len,
        niters=niters, out_len_max=O, phase_init=init_mode)
    return (v_sig[:out_len].cpu().numpy().astype(np.float64),
            m_phase[:nfrms].cpu().numpy().astype(np.float64))
