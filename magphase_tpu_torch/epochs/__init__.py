"""Epoch (pitch-mark) extraction (port of magphase_tpu/epochs)."""
from .tracker import extract_epochs

__all__ = ["extract_epochs"]
