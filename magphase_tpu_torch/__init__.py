"""magphase_tpu_torch — the PyTorch / CUDA port of magphase_tpu.

Mirrors the JAX package's module paths (``core/framing.py`` here is the
counterpart of ``magphase_tpu/core/framing.py``, and so on).  It imports
torch, numpy and scipy only — never jax or magphase_tpu — so it runs on a
machine that has neither.  The Pallas kernels of the JAX package on its
paths are hand-written CUDA C++ here: framing/OLA in ``csrc/framing.cu``
(bound in ``kernels/framing.py``), the epoch walk in ``csrc/walk.cu``
(``kernels/walk.py``) and the fused real DFT of the JAX package's tool in
``csrc/dft.cu`` (``kernels/dft.py``); everything else is plain torch
(cuFFT, cuBLAS).  Public entry points run on the card unless called with
``device="cpu"``.  Importing the package builds no kernel: each library
is built at its first launch.  The top level exports the configuration
and every name of ``vocoder`` (the JAX package's vocoder entries).
"""
from . import vocoder as _vocoder
from .config import (DEFAULT_16K, DEFAULT_48K, MagPhaseConfig, define_alpha,
                     define_crossfade_params, define_fft_len, from_jax_config)
from .vocoder import *  # noqa: F401,F403 (every name of vocoder.__all__)

__version__ = "0.1.0"

__all__ = ["MagPhaseConfig", "define_alpha", "define_fft_len",
           "define_crossfade_params", "from_jax_config", "DEFAULT_48K",
           "DEFAULT_16K", *_vocoder.__all__]
