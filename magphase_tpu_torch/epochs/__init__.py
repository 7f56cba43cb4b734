"""Epoch (pitch-mark) extraction (port of magphase_tpu/epochs)."""
from .tracker import extract_epochs, place_epochs, track_f0


def get_pitch_marks(v_sig, fs: int, *, device="cuda"):
    """Pitch-mark times in seconds from the tracker (libaudio.py:469-491
    parity, as the JAX package's ``get_pitch_marks``): the first item of
    ``extract_epochs``, which also gives the voicing flags."""
    return extract_epochs(v_sig, fs, device=device)[0]


__all__ = ["extract_epochs", "track_f0", "place_epochs",
           "get_pitch_marks"]
