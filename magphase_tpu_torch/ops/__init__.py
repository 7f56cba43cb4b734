"""Public op namespace: the building blocks of the vocoder as torch ops
over dense (frames, bins) tensors (port of magphase_tpu/ops, with the
same names).

  framing   — pitch-synchronous frame gather / overlap-add (kernels K1-K3
              on the card)
  windows   — closed-form asymmetric window evaluation
  spectral  — hermitian half, rceps/min-phase, crossfade, mel curve, log/db,
              true envelope
  melcep    — mel-cepstrum solve + warp/unwarp (SPTK mcep/freqt/c2acr/
              mc2b/b2mc replacements)
  fbank     — filter-bank warp family
  filters   — medfilt, parallel-prefix lfilter, FFT-convolution sosfilt
  interp    — coefficient extension / linear maps
  misc_dsp  — the remaining libaudio utility surface (smoothing,
              unvoiced-region interp, spectral RMS, masks, ...)
"""
from ..core import (fbank, filters, framing, interp, melcep, misc_dsp,
                    spectral, windows)
from ..core.filters import butter_highpass_sos, lfilter, medfilt3, sosfilt
from ..core.framing import (apply_anti_ringing, frame_geometry, ola_centered,
                            ola_centered_batch, pitch_sync_frames,
                            pitch_sync_frames_batch)
from ..core.melcep import (b2mc, c2acr_r0, freqt, mc2b, mcep_to_sp_cosmat,
                           sp_mel_unwarp, sp_mel_warp, sp_to_mcep)
from ..core.misc_dsp import (gen_mask_simple, interp_unv_regions,
                             mcep_to_lin_sp_log, mix_by_mask,
                             next_pow_of_two, smooth_by_conv, win_squared)
from ..core.spectral import (add_hermitian_half, build_mel_curve,
                             build_min_phase_from_mag_spec, db, get_rms,
                             protected_log, rceps, remove_hermitian_half,
                             spectral_crossfade, true_envelope)

__all__ = [
    "fbank", "filters", "framing", "interp", "melcep", "spectral",
    "windows", "frame_geometry", "ola_centered", "ola_centered_batch",
    "pitch_sync_frames", "pitch_sync_frames_batch", "apply_anti_ringing",
    "sp_to_mcep", "sp_mel_warp", "sp_mel_unwarp", "mcep_to_sp_cosmat",
    "freqt", "c2acr_r0", "mc2b", "b2mc", "add_hermitian_half",
    "remove_hermitian_half", "build_min_phase_from_mag_spec",
    "build_mel_curve", "protected_log", "db", "rceps", "true_envelope",
    "spectral_crossfade", "medfilt3", "lfilter", "sosfilt",
    "butter_highpass_sos", "misc_dsp", "smooth_by_conv",
    "interp_unv_regions", "mcep_to_lin_sp_log", "next_pow_of_two",
    "win_squared", "gen_mask_simple", "mix_by_mask", "get_rms",
]
