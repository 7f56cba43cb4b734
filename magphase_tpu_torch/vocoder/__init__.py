"""Vocoder pipelines (port of magphase_tpu/vocoder: the lossless path, the
compressed analysis and synthesis, the post-filters and the frame-rate
conversion)."""
from . import framerate
from .compressed import (analysis_compressed, analysis_for_acoustic_modelling,
                         format_for_modelling,
                         get_num_full_mel_coeffs_from_num_phase_coeffs,
                         phase_uncompress_type1_mcep,
                         synthesis_from_acoustic_modelling,
                         synthesis_from_compressed)
from .lossless import (analysis_lossless, analysis_with_del_comp_from_pm,
                       densify_pitch_marks, f0_to_shift, pm_to_shift,
                       shift_to_pm, synthesis_from_lossless,
                       synthesis_with_del_comp)
from .postfilter import post_filter, post_filter_merlin

__all__ = ["analysis_compressed", "analysis_for_acoustic_modelling",
           "analysis_lossless", "analysis_with_del_comp_from_pm",
           "densify_pitch_marks", "f0_to_shift", "format_for_modelling",
           "framerate", "get_num_full_mel_coeffs_from_num_phase_coeffs",
           "phase_uncompress_type1_mcep", "pm_to_shift", "post_filter",
           "post_filter_merlin", "shift_to_pm",
           "synthesis_from_acoustic_modelling", "synthesis_from_compressed",
           "synthesis_from_lossless", "synthesis_with_del_comp"]
