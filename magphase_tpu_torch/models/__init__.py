from .magphase import MagPhaseVocoder

__all__ = ["MagPhaseVocoder"]
