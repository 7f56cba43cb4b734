"""High-level vocoder facade (port of magphase_tpu/models/magphase.py).

One typed configuration behind the analysis and synthesis entries, so an
application holds a single object instead of threading (fs, fft_len,
dims, const_rate, pf_type, ...) through every call.  Every method runs on
the facade's ``device``: the card unless it was built with
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import MagPhaseConfig


@dataclass
class MagPhaseVocoder:
    """MagPhase-class pitch-synchronous vocoder (analysis + synthesis).

    >>> voc = MagPhaseVocoder(fs=48000, mag_dim=60, phase_dim=45)
    >>> feats = voc.analyze("utt.wav")                    # compressed
    >>> wav = voc.synthesize(*feats)                      # waveform
    """
    fs: int = 48000
    fft_len: int | None = None
    mag_dim: int = 60
    phase_dim: int = 45
    b_const_rate: bool = False
    pf_type: str = "no"                 # 'no' | 'magphase' | 'merlin'
    b_voi_ap_win: bool = True
    per_phase_type: str = "magphase"    # 'magphase' | 'min_phase' | 'linear'
    b_out_hpf: bool = True
    config: MagPhaseConfig = field(init=False)
    device: str = field(default="cuda", kw_only=True)

    def __post_init__(self):
        self.config = (MagPhaseConfig(fs=self.fs) if self.fft_len is None
                       else MagPhaseConfig(fs=self.fs, fft_len=self.fft_len))
        self.fft_len = self.config.fft_len

    # ----- analysis ------------------------------------------------------
    def analyze_lossless(self, wav_file: str, **kw):
        """(m_mag, m_real, m_imag, v_f0, fs, v_shift) — magphase.py:2869."""
        from ..vocoder import analysis_lossless
        return analysis_lossless(wav_file, fft_len=self.fft_len,
                                 device=self.device, **kw)

    def analyze(self, wav_file: str, **kw):
        """Compressed features (mag_mel_log, real_mel, imag_mel, lf0,
        shift, fs, fft_len) — magphase.py:2947."""
        from ..vocoder import analysis_compressed
        return analysis_compressed(
            wav_file, fft_len=self.fft_len, mag_dim=self.mag_dim,
            phase_dim=self.phase_dim, b_const_rate=self.b_const_rate,
            device=self.device, **kw)

    def extract_to_dir(self, wav_file: str, out_dir: str, **kw) -> None:
        """Write .mag/.real/.imag/.lf0[/.shift] — magphase.py:2992."""
        from ..vocoder import analysis_for_acoustic_modelling
        analysis_for_acoustic_modelling(
            wav_file, out_dir, fft_len=self.fft_len, mag_dim=self.mag_dim,
            phase_dim=self.phase_dim, b_const_rate=self.b_const_rate,
            device=self.device, **kw)

    def analyze_batch(self, signals: list, mesh=None, **kw) -> list:
        """Batched compressed analysis (tracker + analysis + compression);
        a ``mesh`` raises ValueError, as in the batch entry."""
        from ..parallel.analysis_batch import analysis_compressed_batch
        return analysis_compressed_batch(
            signals, self.fs, mag_dim=self.mag_dim,
            phase_dim=self.phase_dim, fft_len=self.fft_len,
            b_const_rate=self.b_const_rate, mesh=mesh, device=self.device,
            **kw)

    def analyze_lossless_batch(self, signals: list, mesh=None, **kw) -> list:
        from ..parallel.analysis_batch import analysis_lossless_batch
        return analysis_lossless_batch(signals, self.fs,
                                       fft_len=self.fft_len, mesh=mesh,
                                       device=self.device, **kw)

    # ----- synthesis -----------------------------------------------------
    def synthesize_lossless(self, m_mag, m_real, m_imag, v_f0) -> np.ndarray:
        from ..vocoder import synthesis_from_lossless
        return synthesis_from_lossless(m_mag, m_real, m_imag, v_f0, self.fs,
                                       device=self.device)

    def synthesize(self, m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0,
                   v_shift=None, fs=None, fft_len=None, *, key=None
                   ) -> np.ndarray:
        """Waveform from compressed/predicted features — magphase.py:825
        (with the post-filter of ``pf_type`` applied first, 3259-3268).

        Accepts the full 7-tuple of :meth:`analyze` (``synthesize(*feats)``);
        the trailing ``v_shift``/``fs``/``fft_len`` are informational, but
        a conflicting ``fs`` or ``fft_len`` raises.  ``key``: the (2,)
        uint32 noise key (``utils.keys.prng_key(0)`` when None)."""
        if fs is not None and int(fs) != self.fs:
            raise ValueError(f"feature fs {fs} != vocoder fs {self.fs}")
        if fft_len is not None and int(fft_len) != self.fft_len:
            raise ValueError(
                f"feature fft_len {fft_len} != vocoder fft_len "
                f"{self.fft_len}")
        from ..vocoder import synthesis_from_compressed
        mag = self._post_filtered(m_mag_mel_log)
        return synthesis_from_compressed(
            mag, m_real_mel, m_imag_mel, v_lf0, self.fs,
            fft_len=self.fft_len, b_voi_ap_win=self.b_voi_ap_win,
            b_const_rate=self.b_const_rate,
            per_phase_type=self.per_phase_type, b_out_hpf=self.b_out_hpf,
            key=key, device=self.device)

    def synthesize_batch(self, utts, key=None, mesh=None) -> list:
        """Batched synthesis — the serving path; a ``mesh`` raises
        ValueError, as in the batch entry."""
        from ..parallel.batch import synthesis_from_compressed_batch
        return synthesis_from_compressed_batch(
            utts, self.fs, fft_len=self.fft_len,
            b_voi_ap_win=self.b_voi_ap_win,
            per_phase_type=self.per_phase_type, b_out_hpf=self.b_out_hpf,
            pf_type=self.pf_type, key=key, mesh=mesh, device=self.device)

    def synthesize_from_dir(self, feats_dir: str, token: str, out_dir: str,
                            key=None) -> None:
        from ..vocoder import synthesis_from_acoustic_modelling
        synthesis_from_acoustic_modelling(
            feats_dir, token, out_dir, self.mag_dim, self.phase_dim,
            self.fs, fft_len=self.fft_len, pf_type=self.pf_type,
            b_const_rate=self.b_const_rate, key=key, device=self.device)

    # ----- helpers -------------------------------------------------------
    def _post_filtered(self, m_mag_mel_log):
        from ..vocoder.compressed import post_filtered
        return post_filtered(m_mag_mel_log, self.fs, self.pf_type,
                             device=self.device)
