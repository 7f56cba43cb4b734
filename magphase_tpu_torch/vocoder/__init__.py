"""Vocoder pipelines (port of magphase_tpu/vocoder: the lossless path and
its float64 host form, the compressed analysis and synthesis, the variant
vocoders and phase-comp, Griffin-Lim, the post-filters and the frame-rate
conversion)."""
from . import framerate
from .compressed import (analysis_compressed, analysis_for_acoustic_modelling,
                         format_for_modelling,
                         get_num_full_mel_coeffs_from_num_phase_coeffs,
                         phase_uncompress_type1_mcep,
                         synthesis_from_acoustic_modelling,
                         synthesis_from_compressed)
from .griffin_lim import griffin_lim
from .lossless import (analysis_lossless, analysis_with_del_comp_from_pm,
                       analysis_with_del_comp_from_pm_type2,
                       densify_pitch_marks, f0_to_shift, pm_to_shift,
                       shift_to_pm, synthesis_from_lossless,
                       synthesis_with_del_comp)
from .lossless_f64 import (analysis_lossless_f64, copy_synthesis_f64,
                           synthesis_from_lossless_f64)
from .phase_comp import (analysis_compressed_type1_with_phase_comp,
                         format_for_modelling_phase_comp,
                         synthesis_from_compressed_type1_with_phase_comp)
from .postfilter import (post_filter, post_filter_backup_old,
                         post_filter_dev, post_filter_merlin)
from .variants import (analysis_compressed_type1, analysis_compressed_type2,
                       analysis_lossless_type2, compute_imag_from_real,
                       phase_uncompress_fbank, phase_uncompress_type1,
                       synthesis_from_compressed_type1,
                       synthesis_from_compressed_type1_old_with_griffin_lim,
                       synthesis_from_compressed_type2)

__all__ = [
    "analysis_compressed_type1", "analysis_compressed_type2",
    "analysis_lossless_type2", "compute_imag_from_real",
    "phase_uncompress_type1", "phase_uncompress_fbank",
    "synthesis_from_compressed_type1", "synthesis_from_compressed_type2",
    "synthesis_from_compressed_type1_old_with_griffin_lim",
    "analysis_compressed_type1_with_phase_comp",
    "format_for_modelling_phase_comp",
    "synthesis_from_compressed_type1_with_phase_comp", "griffin_lim",
    "analysis_lossless", "analysis_with_del_comp_from_pm",
    "analysis_with_del_comp_from_pm_type2", "densify_pitch_marks",
    "synthesis_from_lossless", "synthesis_with_del_comp", "f0_to_shift",
    "shift_to_pm", "pm_to_shift", "analysis_compressed",
    "analysis_for_acoustic_modelling", "format_for_modelling",
    "synthesis_from_compressed", "synthesis_from_acoustic_modelling",
    "phase_uncompress_type1_mcep",
    "get_num_full_mel_coeffs_from_num_phase_coeffs", "post_filter",
    "post_filter_merlin", "post_filter_dev", "post_filter_backup_old",
    "framerate", "analysis_lossless_f64", "synthesis_from_lossless_f64",
    "copy_synthesis_f64",
]
