"""Lossless copy-synthesis demo (counterpart of
examples/demo_copy_synthesis_lossless.py; reference:
demos/demo_copy_synthesis_lossless.py).

Extracts high-resolution MagPhase parameters (mag / real / imag / f0) from
a wave file, epochs from the port's tracker, and resynthesises it.

Run:  python -m magphase_tpu_torch.examples.demo_copy_synthesis_lossless
      [wav] [out_dir] [--device cuda]
Without a wav it runs on synthetic speech (utils/tracker_eval.py).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..io import get_filename, mkdir, read_wav, write_audio_file
from ..vocoder import analysis_lossless, synthesis_from_lossless
from . import _common


def copy_synthesis(wav_file: str, device):
    """(input signal, resynthesis, fs): the lossless analysis of
    ``wav_file`` on ``device`` and its synthesis."""
    print("Analysing...")
    m_mag, m_real, m_imag, v_f0, fs, _v_shift = analysis_lossless(
        wav_file, device=device)
    print("Synthesising...")
    v_syn_sig = synthesis_from_lossless(m_mag, m_real, m_imag, v_f0, fs,
                                        device=device)
    return read_wav(wav_file)[0], v_syn_sig, fs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("wav", nargs="?", default=None)
    ap.add_argument("out_dir", nargs="?", default="magphase_torch_syn")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = _common.device(args.device)
    mkdir(args.out_dir)
    wav_file_orig = args.wav or _common.synthetic_wav(args.out_dir,
                                                      "synthetic")

    sig, v_syn_sig, fs = copy_synthesis(wav_file_orig, device)
    n = min(len(sig), len(v_syn_sig))
    err = np.abs(v_syn_sig[:n] - sig[:n])
    print(f"reconstruction: p99 |syn - sig| {np.percentile(err, 99):.3g} "
          f"(one PCM16 step {1 / 32768:.3g})")
    out = os.path.join(args.out_dir,
                       get_filename(wav_file_orig) + "_copy_syn_lossless.wav")
    write_audio_file(out, v_syn_sig, fs)
    print("Wrote", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
