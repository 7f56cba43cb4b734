"""Low-dimensional copy-synthesis demo (counterpart of
examples/demo_copy_synthesis_low_dim.py; reference:
demos/demo_copy_synthesis_low_dim.py): mag_dim=100, phase_dim=45,
variable frame rate, no output high-pass.

Run:  python -m magphase_tpu_torch.examples.demo_copy_synthesis_low_dim
      [wav] [out_dir] [--device cuda]
Without a wav it runs on synthetic speech (utils/tracker_eval.py).
"""
from __future__ import annotations

import argparse
import os

from ..io import get_filename, mkdir, write_audio_file
from ..vocoder import analysis_compressed, synthesis_from_compressed
from . import _common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("wav", nargs="?", default=None)
    ap.add_argument("out_dir", nargs="?", default="magphase_torch_syn")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = _common.device(args.device)
    mag_dim, phase_dim, b_const_rate = 100, 45, False
    mkdir(args.out_dir)
    wav_file_orig = args.wav or _common.synthetic_wav(args.out_dir,
                                                      "synthetic")

    print("Analysing...")
    (m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0, v_shift, fs,
     fft_len) = analysis_compressed(wav_file_orig, mag_dim=mag_dim,
                                    phase_dim=phase_dim,
                                    b_const_rate=b_const_rate, device=device)

    print("Synthesising...")
    v_syn_sig = synthesis_from_compressed(m_mag_mel_log, m_real_mel,
                                          m_imag_mel, v_lf0, fs,
                                          b_const_rate=b_const_rate,
                                          b_out_hpf=False, device=device)

    out = os.path.join(
        args.out_dir, get_filename(wav_file_orig) +
        f"_copy_syn_low_dim_mag_dim_{mag_dim}_ph_dim_{phase_dim}"
        f"_const_rate_{int(b_const_rate)}.wav")
    write_audio_file(out, v_syn_sig, fs)
    print("Wrote", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
