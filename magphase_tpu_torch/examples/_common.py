"""What the examples share: the device flag and synthetic speech where
the demo corpus is absent."""
from __future__ import annotations

import os

import numpy as np
import torch

# the synthetic utterances' segments: (seconds, f0 start, f0 end), f0 None
# for unvoiced (utils/tracker_eval.py:make_stimulus)
SEGMENTS = ((0.15, None, None), (0.8, 110, 160), (0.1, None, None),
            (0.7, 200, 130), (0.15, None, None))


def device(name: str) -> torch.device:
    """``--device``; raises where CUDA is asked for and absent (the
    examples never fall back to the CPU unless asked)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    return dev


def synthetic_wav(out_dir: str, token: str, fs: int = 48000,
                  seed: int = 0) -> str:
    """A PCM16 wav of synthetic speech (make_stimulus; f0 contours shifted
    by ``seed``) at ``out_dir/token.wav``; returns its path."""
    from ..io import write_wav
    from ..utils.tracker_eval import make_stimulus
    shift = 1.0 + 0.07 * seed
    segs = [(d, None if a is None else a * shift,
             None if b is None else b * shift) for d, a, b in SEGMENTS]
    sig = make_stimulus(fs, segs, seed=seed)[0]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, token + ".wav")
    write_wav(path, np.asarray(sig), fs)
    return path
