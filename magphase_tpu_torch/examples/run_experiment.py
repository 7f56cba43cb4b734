"""End-to-end copy-synthesis experiment over a corpus (counterpart of
examples/run_experiment.py; reference: development/run_merlin_experiment.py,
a Merlin training script; Merlin itself is external, so this exercises
the same surface: corpus feature extraction -> waveform generation ->
objective metric, the mel-spectral distortion standing in for CALMCD).

Run:  python -m magphase_tpu_torch.examples.run_experiment
      [--data-dir DIR] [--out-dir DIR] [--mag-dim 60] [--phase-dim 45]
      [--limit N] [--device cuda]
``--data-dir`` holds file_id.scp and wavs_nat/ (the reference's demo
layout); without it the corpus is synthetic speech (utils/tracker_eval.py,
``--limit`` utterances, 4 by default).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from . import _common

SYNTHETIC_UTTS = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--out-dir", default="magphase_torch_experiment")
    ap.add_argument("--mag-dim", type=int, default=60)
    ap.add_argument("--phase-dim", type=int, default=45)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = _common.device(args.device)

    from ..io import mkdir, read_scp_file, read_wav, write_audio_file
    from ..parallel.analysis_batch import analysis_compressed_batch
    from ..parallel.batch import synthesis_from_compressed_batch
    from ..utils.eval import mel_spectral_distortion_piecewise
    from ..utils.keys import prng_key
    from ..utils.metrics import Metrics, setup_logging

    setup_logging()
    met = Metrics()
    mkdir(args.out_dir)
    if args.data_dir is not None:
        wav_dir = os.path.join(args.data_dir, "wavs_nat")
        tokens = read_scp_file(os.path.join(args.data_dir, "file_id.scp"))
        if args.limit:
            tokens = tokens[:args.limit]
    else:
        wav_dir = os.path.join(args.out_dir, "wavs_nat")
        tokens = [f"synthetic_{i}" for i in range(args.limit
                                                  or SYNTHETIC_UTTS)]
        for i, tok in enumerate(tokens):
            _common.synthetic_wav(wav_dir, tok, seed=i)

    sigs, fss = [], set()
    for tok in tokens:
        sig, fs = read_wav(os.path.join(wav_dir, tok + ".wav"))
        sigs.append(sig)
        fss.add(fs)
    (fs,) = fss
    audio_s = sum(len(s) for s in sigs) / fs
    print(f"{len(tokens)} utterances, {audio_s:.1f} audio-s @ {fs} Hz "
          f"on {device}")

    with met.stage("extract"):
        feats = analysis_compressed_batch(sigs, fs, mag_dim=args.mag_dim,
                                          phase_dim=args.phase_dim,
                                          device=device)
    print(f"extract: {audio_s / met.times['extract']:.1f} audio-s/s")

    with met.stage("generate"):
        utts = [(m, r, i, l) for (m, r, i, l, _s) in feats]
        wavs = synthesis_from_compressed_batch(utts, fs, key=prng_key(0),
                                               device=device)
    print(f"generate: {audio_s / met.times['generate']:.1f} audio-s/s")

    msds = []
    for tok, sig, w in zip(tokens, sigs, wavs):
        write_audio_file(os.path.join(args.out_dir, tok + ".wav"), w, fs)
        # floor 40 dB below the peak: without it, digital silence in the
        # natural recording against the vocoder's noise floor dominates
        # the mean with content-free distortion
        msds.append(mel_spectral_distortion_piecewise(
            sig, np.asarray(w), fs, floor_db=40.0))
    print(f"copy-synthesis piecewise MSD (floor 40 dB): "
          f"mean {np.mean(msds):.2f} dB  "
          f"(per-utt {' '.join('%.2f' % m for m in msds)})")
    print("wavs ->", args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
