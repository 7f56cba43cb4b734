"""Serving integration: acoustic model -> vocoder on the card, with only
the linguistic features going up and the PCM16 waveform coming down
(counterpart of examples/serving_on_device.py).

The reference's serving story is file-based: Merlin writes predicted
.mag/.real/.imag/.lf0 to disk, then batch_waveform_generation.py reads
them back and vocodes (scripts/batch_waveform_generation.py:58-63).  Here
a stand-in acoustic network (a small MLP over linguistic features, an
``nn.Module``; swap in any torch model) feeds the compressed synthesis
(mel-unwarp -> masks/noise -> iFFT -> PSOLA, kernel K2) on the same
device, and the waveform is encoded to PCM16 there.  ``params_from_jax``
carries the JAX example's weights (``init_acoustic_params``) across.

Run:  python -m magphase_tpu_torch.examples.serving_on_device [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import define_alpha, define_crossfade_params
from ..parallel.batch import _pcm16_kernel
from ..utils.keys import prng_key, split
from ..vocoder.compressed import (
    SynthesisTables, _unwarp_kernel,
    get_num_full_mel_coeffs_from_num_phase_coeffs, synthesis_core_batch)

FS = 48000
FFT_SYN = 2048          # 50 Hz-floored deterministic synthesis FFT
MAG_DIM, PHASE_DIM = 60, 45
LING_DIM = 128          # stand-in linguistic feature width
OUT_DIM = MAG_DIM + 2 * PHASE_DIM + 1
F = 256                 # frames per utterance (padded)
B = 8                   # utterances per batch
OUT_LEN_MAX = 1 << 18


class AcousticModel(torch.nn.Module):
    """A stand-in acoustic model: a 2-layer MLP emitting the four MagPhase
    streams per frame."""

    def __init__(self, hidden: int = 256):
        super().__init__()
        self.l1 = torch.nn.Linear(LING_DIM, hidden)
        self.l2 = torch.nn.Linear(hidden, OUT_DIM)

    def forward(self, ling):
        y = self.l2(torch.tanh(self.l1(ling)))
        mag_mel_log = y[..., :MAG_DIM] - 3.0
        real_mel = torch.clamp(y[..., MAG_DIM:MAG_DIM + PHASE_DIM], -1, 1)
        imag_mel = torch.clamp(y[..., MAG_DIM + PHASE_DIM:-1], -1, 1)
        # stand-in prosody: smooth lf0 around 120 Hz, all voiced
        lf0 = float(np.log(120.0)) + 0.1 * torch.tanh(y[..., -1])
        return mag_mel_log, real_mel, imag_mel, lf0


def init_acoustic_model(seed: int = 0, hidden: int = 256) -> AcousticModel:
    """The model with N(0, 0.05^2) weights from ``seed`` and zero biases,
    as the JAX example initialises its MLP."""
    g = torch.Generator().manual_seed(seed)
    model = AcousticModel(hidden)
    with torch.no_grad():
        for lin in (model.l1, model.l2):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g)
                             * 0.05)
            lin.bias.zero_()
    return model


def params_from_jax(params) -> dict:
    """The state dict of ``AcousticModel`` holding the JAX example's
    weights: ``{"w1", "b1", "w2", "b2"}`` as arrays (``y = x @ w + b``)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))
    return {"l1.weight": t(np.asarray(params["w1"]).T),
            "l1.bias": t(params["b1"]),
            "l2.weight": t(np.asarray(params["w2"]).T),
            "l2.bias": t(params["b2"])}


def _mag_dim_ph() -> int:
    return get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(FS)[0], PHASE_DIM, define_alpha(FS), FS)


def synthesis_tables(device) -> SynthesisTables:
    """The constant tables of the serving configuration on ``device``."""
    alpha = define_alpha(FS)
    return SynthesisTables(fs=FS, fft_len=FFT_SYN, alpha=alpha,
                           alpha_phase=alpha, mag_dim=MAG_DIM,
                           mag_dim_ph=_mag_dim_ph()).to(device)


@torch.no_grad()
def tts_step(model, ling, keys, tables: SynthesisTables):
    """Linguistic features (B, F, LING_DIM) and (B, 2) noise keys (int64
    tensors of uint32 values) -> (PCM16 (B, OUT_LEN_MAX) int16, lengths
    (B,)), all on the device of ``ling``: the acoustic model, the frame
    geometry from its lf0 (float32 shifts; the host float64 geometry is
    for file round trips), mel-unwarp, synthesis and the PCM16 encode."""
    alpha = define_alpha(FS)
    mag_mel_log, real_mel, imag_mel, lf0 = model(ling)
    Bx, Fx, _ = mag_mel_log.shape
    f0 = torch.exp(lf0)
    voi = (f0 > 1.0).to(torch.float32)
    # a true division: torch computes scalar / tensor as a reciprocal
    # times the scalar, which rounds twice
    shifts = torch.floor(torch.full_like(f0, FS)
                         / torch.where(f0 == 0.0, 200.0, f0)).to(torch.int32)
    pm = torch.cumsum(shifts, dim=1, dtype=torch.int32)
    nfrms = torch.full((Bx,), Fx, dtype=torch.int32, device=ling.device)
    ns_len = pm[:, -1] + (pm[:, -1] - pm[:, -2])
    h = FFT_SYN // 2 + 1
    m_mag, m_real, m_imag = _unwarp_kernel(
        mag_mel_log.reshape(Bx * Fx, MAG_DIM),
        real_mel.reshape(Bx * Fx, PHASE_DIM),
        imag_mel.reshape(Bx * Fx, PHASE_DIM), fft_len=FFT_SYN,
        mag_dim_ph=_mag_dim_ph(), alpha=alpha, alpha_phase=alpha,
        tables=tables)
    bufs = synthesis_core_batch(
        m_mag.reshape(Bx, Fx, h), m_real.reshape(Bx, Fx, h),
        m_imag.reshape(Bx, Fx, h), voi, pm, shifts, nfrms, ns_len, keys,
        fs=FS, fft_len=FFT_SYN, alpha=alpha, b_voi_ap_win=True,
        per_phase_type="magphase", out_len_max=OUT_LEN_MAX, tables=tables)
    lens = ns_len + 1
    return _pcm16_kernel(bufs, lens), lens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default="magphase_torch_syn")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu")

    model = init_acoustic_model(0).to(device)
    ling = torch.randn(B, F, LING_DIM,
                       generator=torch.Generator().manual_seed(1)).to(device)
    keys = torch.from_numpy(split(prng_key(2), B).astype(np.int64)).to(device)
    tables = synthesis_tables(device)

    pcm, lens = tts_step(model, ling, keys, tables)
    pcm, lens = pcm.cpu().numpy(), lens.cpu().numpy()
    audio_s = float(lens.sum()) / FS
    print(f"batch of {B}: {audio_s:.1f} s of audio, pcm dtype {pcm.dtype}")

    t0 = time.perf_counter()
    pcm2, _ = tts_step(model, ling, keys, tables)
    pcm2.cpu()                                      # waits for the device
    dt = time.perf_counter() - t0
    print(f"warm step on {device}: {dt * 1e3:.1f} ms -> {audio_s / dt:.0f} "
          "audio-s/s (acoustic model + vocoder + PCM16)")

    from ..io.wav import write_wav_pcm16
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "serving_demo.wav")
    write_wav_pcm16(out, pcm[0, :int(lens[0])], FS)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
