"""The port's variant vocoders (vocoder/variants.py, vocoder/phase_comp.py)
against the JAX package: type1, type2 and phase-comp analysis and
synthesis, the old AP-mask synthesis with and without Griffin-Lim, the
type-2 lossless analysis, on make_stimulus speech from its true epochs.
One 48 kHz case per entry, 16 kHz for the rest.

The noise of both packages is the same draw (keys.uniform is
jax.random.uniform bit for bit), so the syntheses are compared sample by
sample.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

import magphase_tpu.vocoder as jv
import magphase_tpu_torch.vocoder as tv
from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu_torch.io import wav as twav
from magphase_tpu_torch.utils.keys import prng_key

KEY = prng_key(5)
JKEY = jax.numpy.asarray(KEY)
CPU = dict(device="cpu")


def _speech(fs, seed=3):
    """(signal, pm_sec, voi): unvoiced, voiced, unvoiced make_stimulus
    speech with the true epochs in its voiced run and marks every 5 ms
    elsewhere."""
    sig, gci = make_stimulus(fs, [(0.15, None, None), (0.5, 110, 180),
                                  (0.15, None, None)], seed=seed)[:2]
    step = 0.005
    unv = np.r_[np.arange(step, 0.15, step), np.arange(0.655, 0.795, step)]
    pm = np.sort(np.r_[unv, gci[1:-1]])
    voi = ((pm > 0.15) & (pm < 0.65)).astype(np.float64)
    return sig, pm, voi


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """case(fs): a wav of _speech at fs, its epochs, and its type-1
    compressed features (40 mag / 20 phase coefficients) from the JAX
    package, variable and constant (5 ms) rate; built once per rate."""
    made = {}

    def case(fs):
        if fs not in made:
            sig, pm, voi = _speech(fs)
            wav = str(tmp_path_factory.mktemp("variants") / f"utt_{fs}.wav")
            twav.write_wav(wav, sig, fs)
            ep = dict(pm_sec=pm, voi=voi)
            feats = jv.analysis_compressed_type1(wav, mag_dim=40,
                                                 phase_dim=20, **ep)
            feats_c = jv.analysis_compressed_type1(
                wav, mag_dim=40, phase_dim=20, const_rate_ms=5.0, **ep)
            made[fs] = dict(fs=fs, wav=wav, ep=ep, feats=feats[:4],
                            feats_c=feats_c[:4])
        return made[fs]

    return case


def _cases(variants):
    """(fs, kw) parameters: every variant at 16 kHz, the first at 48 kHz."""
    return [pytest.param(16000, kw, id=f"16k-{kw}") for kw in variants] + \
        [pytest.param(48000, variants[0], id=f"48k-{variants[0]}")]


def _audio_close(got, ref, bound=1e-5):
    """Waveforms of equal length within ``bound`` of the reference's peak.
    1e-5: float32 FFT round-off of two FFT libraries over the unwarp, the
    noise and synthesis FFTs, and the noise gains summed in another order
    (measured below 1e-6 of the peak)."""
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got)) and np.std(got) > 1e-4
    assert np.abs(got - ref).max() <= bound * np.abs(ref).max()


def _streams_close(got, ref, rel=1e-4):
    """Compressed streams: within ``rel`` of each stream's largest value
    (float32 mel warps by matmul and FFT round-off; measured 3e-5 on the
    log magnitude, whose -log floor frames reach |20|)."""
    for g, r in zip(got, ref):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= rel * max(np.abs(r).max(), 1.0)


# ---------------------------------------------------------------------------
# analysis

@pytest.mark.parametrize("fs", [16000, 48000], ids=["16k", "48k"])
def test_analysis_compressed_type1_matches_jax(cases, fs):
    """analysis_compressed_type1 (variable and constant rate): the
    streams within 1e-3 of each stream's largest value.  The JAX
    package's compressed analysis takes its forward DFT as a matmul at
    ~1e-5 of the frame's peak (its analysis_batch.py:298-306); the log
    magnifies that at the spectral valleys of the quiet unvoiced frames
    (measured 3.7e-3 on a log magnitude of peak 6 at 16 kHz, 1.2e-5 at
    48 kHz)."""
    case = cases(fs)
    got = tv.analysis_compressed_type1(case["wav"], mag_dim=40, phase_dim=20,
                                       **case["ep"], **CPU)
    _streams_close(got[:4], case["feats"], rel=1e-3)
    got_c = tv.analysis_compressed_type1(case["wav"], mag_dim=40,
                                         phase_dim=20, const_rate_ms=5.0,
                                         **case["ep"], **CPU)
    _streams_close(got_c[:4], case["feats_c"], rel=1e-3)


@pytest.mark.parametrize("fs,kw", _cases([dict(), dict(b_norm_mag=True),
                                          dict(const_rate_ms=5.0)]))
def test_analysis_compressed_type2_matches_jax(cases, fs, kw):
    """Type-2 analysis: even/odd interleaved magnitudes through the true
    envelope, the per-frame gain as a log-gain stream (b_norm_mag: the
    per-frame mean in coefficient 0), optionally on the 5 ms grid."""
    case = cases(fs)
    got = tv.analysis_compressed_type2(case["wav"], mag_dim=40, phase_dim=20,
                                       **kw, **case["ep"], **CPU)
    ref = jv.analysis_compressed_type2(case["wav"], mag_dim=40, phase_dim=20,
                                       **kw, **case["ep"])
    _streams_close(got[:4] + (got[7],), ref[:4] + (ref[7],))
    np.testing.assert_array_equal(got[4], ref[4])
    assert got[5:7] == ref[5:7]


def test_analysis_lossless_type2_matches_jax(cases):
    """The type-2 lossless streams (the true-envelope magnitude, the
    phasors, f0, shifts and gains, the first frame dropped): magnitudes
    within 1e-4 of their peak (100 true-envelope iterations of FFT
    round-off), phasors within 1e-4 where the magnitude is above 1e-3 of
    its peak, f0 and shifts equal, gains within 1e-5 relative."""
    case = cases(16000)
    got = tv.analysis_lossless_type2(case["wav"], **case["ep"], **CPU)
    ref = jv.analysis_lossless_type2(case["wav"], **case["ep"])
    assert np.abs(got[0] - ref[0]).max() <= 1e-4 * ref[0].max()
    np.testing.assert_array_equal(got[3], ref[3])
    assert got[4] == ref[4]
    np.testing.assert_array_equal(got[5], ref[5])
    np.testing.assert_allclose(got[6], ref[6], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("fs,kw", _cases([dict(), dict(b_const_rate=True),
                                          dict(b_mag_fbank_mel=True)]))
def test_analysis_phase_comp_matches_jax(cases, fs, kw):
    """analysis_compressed_type1_with_phase_comp: the fbank phase
    compression (not voicing-zeroed), variable and constant rate, mcep
    and fbank magnitude warps."""
    case = cases(fs)
    got = tv.analysis_compressed_type1_with_phase_comp(
        case["wav"], mag_dim=40, phase_dim=10, **kw, **case["ep"], **CPU)
    ref = jv.analysis_compressed_type1_with_phase_comp(
        case["wav"], mag_dim=40, phase_dim=10, **kw, **case["ep"])
    _streams_close(got[:4], ref[:4])
    np.testing.assert_array_equal(got[4], ref[4])


def test_analysis_writes_files(cases, tmp_path):
    """With out_dir the type-2 and phase-comp analyses write their
    streams and return None, as the JAX package does."""
    case = cases(16000)
    (tmp_path / "pc").mkdir()
    assert tv.analysis_compressed_type2(case["wav"], out_dir=str(tmp_path),
                                        mag_dim=40, phase_dim=20,
                                        **case["ep"], **CPU) is None
    assert tv.analysis_compressed_type1_with_phase_comp(
        case["wav"], out_dir=str(tmp_path / "pc"), **case["ep"],
        **CPU) is None
    names = sorted(p.name for p in tmp_path.rglob("utt_*"))
    assert names == sorted(["utt_16000." + e for e in
                            ("mag", "real", "imag", "lf0", "shift")] * 2)


# ---------------------------------------------------------------------------
# synthesis

SYN1 = [dict(), dict(per_phase_type="min_phase"),
        dict(per_phase_type="linear"), dict(b_voi_ap_win=False),
        dict(b_const_rate=True)]


@pytest.mark.parametrize("fs,kw", _cases(SYN1))
def test_synthesis_type1_matches_jax(cases, fs, kw):
    """Type-1 synthesis: per-frame VOI_NOISE / HANNING noise windows (K1),
    no anti-ringing, the unconditional elliptic 60 Hz high-pass."""
    case = cases(fs)
    feats = case["feats_c"] if kw.get("b_const_rate") else case["feats"]
    got = tv.synthesis_from_compressed_type1(*feats, case["fs"], key=KEY,
                                             **kw, **CPU)
    ref = jv.synthesis_from_compressed_type1(*feats, case["fs"], key=JKEY,
                                             **kw)
    _audio_close(got, ref)


@pytest.mark.parametrize("fs,kw", _cases([dict(), dict(hf_slope_coeff=2.0),
                                          dict(const_rate_ms=5.0)]))
def test_synthesis_type2_matches_jax(cases, fs, kw):
    """Type-2 synthesis: the RMS-gain aperiodic mask with the HF slope,
    the deterministic mask, anti-ringing and the 60 Hz high-pass."""
    case = cases(fs)
    feats = case["feats_c"] if "const_rate_ms" in kw else case["feats"]
    got = tv.synthesis_from_compressed_type2(*feats, case["fs"], key=KEY,
                                             **kw, **CPU)
    ref = jv.synthesis_from_compressed_type2(*feats, case["fs"], key=JKEY,
                                             **kw)
    _audio_close(got, ref)


@pytest.mark.parametrize("fs,kw", _cases([
    dict(), dict(per_phase_type="min_phase"), dict(b_fbank_mel=True),
    dict(const_rate_ms=5.0, hf_slope_coeff=2.0)]))
def test_synthesis_type1_old_matches_jax(cases, fs, kw):
    """The old AP-mask synthesis without Griffin-Lim (one global RMS noise
    gain), the key split in two as in the JAX package."""
    case = cases(fs)
    feats = case["feats_c"] if "const_rate_ms" in kw else case["feats"]
    got = tv.synthesis_from_compressed_type1_old_with_griffin_lim(
        *feats, case["fs"], key=KEY, **kw, **CPU)
    ref = jv.synthesis_from_compressed_type1_old_with_griffin_lim(
        *feats, case["fs"], key=JKEY, **kw)
    _audio_close(got, ref)


def _stft_mag(x, fs):
    from scipy import signal as sp_signal
    return np.abs(sp_signal.stft(x, fs, nperseg=512)[2])


@pytest.mark.parametrize("gl", ["det", "whole"])
def test_synthesis_type1_old_griffin_lim_matches_jax(cases, gl):
    """'det' refines the deterministic spectra with 10 Griffin-Lim
    iterations from their own phase, 'whole' re-estimates the signal's
    phase with 50 from the minimum phase.  The phase of near-zero bins
    diverges chaotically between FFT libraries over the iterations, so the
    outputs are held by their magnitude spectrograms (512-point STFT):
    within 1e-3 of the reference's, relative in the Frobenius norm
    (measured 3.0e-6 'det', 3.9e-4 'whole'), and of the same length."""
    case = cases(16000)
    got = tv.synthesis_from_compressed_type1_old_with_griffin_lim(
        *case["feats"], case["fs"], griff_lim_type=gl, key=KEY, **CPU)
    ref = jv.synthesis_from_compressed_type1_old_with_griffin_lim(
        *case["feats"], case["fs"], griff_lim_type=gl, key=JKEY)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    sg, sr = _stft_mag(got, case["fs"]), _stft_mag(ref, case["fs"])
    assert np.linalg.norm(sg - sr) <= 1e-3 * np.linalg.norm(sr)


@pytest.mark.parametrize("fs", [16000, 48000], ids=["16k", "48k"])
def test_synthesis_phase_comp_matches_jax(cases, fs):
    """The phase-comp synthesis from phase-comp features: fbank phase
    uncompression, the type-1 core with the anti-ringing window (then K2),
    the 40 Hz Butterworth high-pass; variable and constant rate, mcep and
    fbank magnitude unwarps."""
    case = cases(fs)
    feats = jv.analysis_compressed_type1_with_phase_comp(
        case["wav"], mag_dim=40, phase_dim=10, **case["ep"])[:4]
    runs = [(feats, dict())]
    if fs == 16000:
        feats_c = jv.analysis_compressed_type1_with_phase_comp(
            case["wav"], mag_dim=40, phase_dim=10, b_const_rate=True,
            **case["ep"])[:4]
        runs += [(feats_c, dict(const_rate_ms=5.0)),
                 (feats, dict(b_fbank_mel=True, per_phase_type="min_phase"))]
    for f, kw in runs:
        got = tv.synthesis_from_compressed_type1_with_phase_comp(
            *f, fs, key=KEY, **kw, **CPU)
        ref = jv.synthesis_from_compressed_type1_with_phase_comp(
            *f, fs, key=JKEY, **kw)
        _audio_close(got, ref)


def test_phase_uncompress_matches_jax():
    """Both phase uncompressions on the same streams: within 1e-5 of the
    streams' values of <= 1 (float32 mel unwarp by matmul)."""
    r = np.random.default_rng(0)
    real = np.clip(r.standard_normal((30, 20)) * 0.3, -1, 1)
    imag = np.clip(r.standard_normal((30, 20)) * 0.3, -1, 1)
    got = tv.phase_uncompress_type1(real, imag, 0.58, 1024, 40, **CPU)
    ref = jv.phase_uncompress_type1(real.astype(np.float32),
                                    imag.astype(np.float32), 0.58, 1024, 40)
    for g, rr in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rr), atol=1e-5)
    got = tv.phase_uncompress_fbank(real[:, :10], imag[:, :10], 5000.0,
                                    1000.0, 0.58, 1024, 16000, **CPU)
    ref = jv.phase_uncompress_fbank(real[:, :10], imag[:, :10], 5000.0,
                                    1000.0, 0.58, 1024, 16000)
    for g, rr in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rr), atol=1e-5)


def test_compute_imag_from_real_matches_jax():
    """The sequential sign choice in float32: equal to the JAX scan."""
    v_real = np.clip(np.random.RandomState(7).randn(64) * 0.5, -0.99, 0.99)
    for sign in (-1.0, 1.0):
        np.testing.assert_array_equal(tv.compute_imag_from_real(sign, v_real),
                                      jv.compute_imag_from_real(sign, v_real))


@pytest.mark.parametrize("name", [
    "synthesis_from_compressed_type1", "synthesis_from_compressed_type2",
    "synthesis_from_compressed_type1_old_with_griffin_lim",
    "synthesis_from_compressed_type1_with_phase_comp",
    "analysis_compressed_type1", "analysis_compressed_type2",
    "analysis_lossless_type2", "analysis_compressed_type1_with_phase_comp",
    "format_for_modelling_phase_comp", "griffin_lim",
    "phase_uncompress_type1", "phase_uncompress_fbank"])
def test_signatures_match_jax(name):
    """The port's positional parameters are the JAX names in the JAX order
    with the same defaults (keys are uint32 pairs in the port); the port
    adds a keyword-only ``device``."""
    ref = inspect.signature(getattr(jv, name)).parameters
    got = inspect.signature(getattr(tv, name)).parameters
    pos = [n for n, p in ref.items() if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert [n for n, p in got.items()
            if p.kind == p.POSITIONAL_OR_KEYWORD] == pos
    for n in pos:
        assert got[n].default == ref[n].default, n
    assert got["device"].kind == inspect.Parameter.KEYWORD_ONLY
    assert got["device"].default == "cuda"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_noise_frames_mixed_families_match_plain(cuda_device):
    """K1 with the window family chosen per frame (VOI_NOISE on voiced
    frames, HANNING on the others), as the variants' noise takes it, on
    the card against its plain version on the same inputs: within 1e-6
    (chip_smoke.py's TOL_FRAMES)."""
    from magphase_tpu_torch.core import framing
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.utils.keys import uniform
    r = np.random.default_rng(1)
    shifts = r.integers(100, 400, 300)
    pm = np.cumsum(shifts)
    voi = (r.random(300) > 0.3).astype(np.float32)
    ns = int(pm[-1] + shifts[-1])
    sig = torch.from_numpy(uniform(KEY, (ns + 1000,), -1.0, 1.0))[None]
    args = [sig, torch.from_numpy(pm[None].astype(np.int32)),
            torch.tensor([300]), torch.tensor([ns])]
    _, L, R, _ = framing.frame_geometry_batch(*args[1:])
    i32 = torch.int32
    a = (sig, args[1].to(i32), L.to(i32), R.to(i32),
         torch.from_numpy(voi[None]), args[2].to(i32), args[3].to(i32))
    kw = dict(fft_len=4096, fam_voiced=1, fam_unvoiced=0)
    ref = K.frames_plain(*a, **kw)
    got = K.frames(*(x.to(cuda_device).contiguous() for x in a), **kw)
    assert float((got.cpu() - ref).abs().max()) <= 1e-6
