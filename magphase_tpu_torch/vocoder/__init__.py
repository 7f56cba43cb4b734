"""Vocoder pipelines (port of magphase_tpu/vocoder: the lossless path, and
the compressed analysis and synthesis cores)."""
from .compressed import format_for_modelling
from .lossless import (analysis_lossless, analysis_with_del_comp_from_pm,
                       densify_pitch_marks, f0_to_shift, pm_to_shift,
                       shift_to_pm, synthesis_from_lossless,
                       synthesis_with_del_comp)

__all__ = ["analysis_lossless", "analysis_with_del_comp_from_pm",
           "densify_pitch_marks", "f0_to_shift", "format_for_modelling",
           "pm_to_shift", "shift_to_pm", "synthesis_from_lossless",
           "synthesis_with_del_comp"]
