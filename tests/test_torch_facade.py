"""The single-utterance compressed vocoder and the MagPhaseVocoder facade of
the port against the JAX package: analysis_compressed (constant frame rate
and the filter-bank warp on and off), synthesis_from_compressed, the file
entries, batch == single, analysis_compressed_batch(b_const_rate=True),
the facade round trip, the ns_len_max keyword of synthesis_core_batch, and
the signatures of every entry this slice adds.  Inputs: 1 s of synthetic
speech at 48 kHz (make_stimulus) written as a PCM16 wav, and the recorded
epochs of tests/data/epochs_48k.npz.
"""
import inspect
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from magphase_tpu.core import framing as jframing
from magphase_tpu.io import wav as jwav
from magphase_tpu.models import magphase as jmodels
from magphase_tpu.parallel import analysis_batch as jab
from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu.vocoder import compressed as jc
from magphase_tpu.vocoder import framerate as jfr
import magphase_tpu.vocoder as jvocoder
from magphase_tpu.core import interp as jinterp
from magphase_tpu.core import fbank as jfbank
from magphase_tpu_torch.core import fbank as tfbank
from magphase_tpu_torch.core import framing as tframing
from magphase_tpu_torch.core import interp as tinterp
from magphase_tpu_torch.io import featfile as tfeat
from magphase_tpu_torch.io import wav as twav
from magphase_tpu_torch.models import magphase as tmodels
from magphase_tpu_torch.parallel import analysis_batch as tab
from magphase_tpu_torch.parallel import batch as tbatch
from magphase_tpu_torch.utils.keys import prng_key, split
from magphase_tpu_torch.vocoder import compressed as tc
from magphase_tpu_torch.vocoder import framerate as tfr
import magphase_tpu_torch.vocoder as tvocoder

FS = 48000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXED = [(0.2, None, None), (0.3, 140, 200), (0.15, None, None),
         (0.25, 220, 110), (0.1, None, None)]
CPU = dict(device="cpu")
# mel streams of the port's analysis against the JAX entry's, whose DFT is
# a matmul at relative error ~1e-5 (analysis_batch.py:298-306); measured
# <= 7.9e-5 here (the facade's tracked analysis; 2.2e-5 at most elsewhere)
TOL_MEL = 5e-4
TOL_LF0_REL = 1e-6
# synthesis from the same features, of the waveform's peak (measured
# <= 1.2e-6: float32 FFT and matmul round-off in another order)
TOL_WAV = 1e-5


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    sig = make_stimulus(FS, MIXED, seed=1)[0]
    path = str(tmp_path_factory.mktemp("wav") / "utt.wav")
    jwav.write_wav(path, sig, FS)
    return path


@pytest.fixture(scope="module")
def epochs():
    """Recorded marks (s) and voicing of hvd_593, cut to 1 s."""
    d = np.load(os.path.join(REPO, "tests", "data", "epochs_48k.npz"))
    pm, voi = d["hvd_593_pm"], d["hvd_593_voi"]
    keep = pm < 1.0
    return pm[keep], voi[keep]


def _assert_features_close(got, ref):
    """(mag_mel_log, real_mel, imag_mel, lf0, shift, ...): shapes equal,
    mel streams within TOL_MEL, lf0 within TOL_LF0_REL relative, shift and
    the trailing scalars equal."""
    assert [np.shape(a) for a in got] == [np.shape(b) for b in ref]
    for i in range(3):
        np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=TOL_MEL)
    np.testing.assert_allclose(got[3], ref[3], rtol=TOL_LF0_REL, atol=0)
    np.testing.assert_array_equal(got[4], ref[4])
    assert tuple(got[5:]) == tuple(ref[5:])


def _assert_wav_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL_WAV * np.abs(ref).max())


# ---------------------------------------------------------------------------
# compressed analysis

@pytest.mark.parametrize("b_mag_fbank_mel", [False, True],
                         ids=["mcep", "fbank"])
@pytest.mark.parametrize("b_const_rate", [False, True],
                         ids=["variable", "const"])
def test_analysis_compressed_matches_jax(wav_file, epochs, b_const_rate,
                                         b_mag_fbank_mel):
    kw = dict(mag_dim=60, phase_dim=45, b_const_rate=b_const_rate,
              b_mag_fbank_mel=b_mag_fbank_mel, pm_sec=epochs[0],
              voi=epochs[1])
    ref = jc.analysis_compressed(wav_file, **kw)
    got = tc.analysis_compressed(wav_file, **kw, **CPU)
    if b_const_rate:       # the streams on the 5 ms grid, shift variable
        grid = np.arange(240.0, np.cumsum(got[4])[-1], 240.0)
        assert got[0].shape[0] == len(grid)
        assert got[4].shape[0] == len(epochs[0])
    _assert_features_close(got, ref)


def test_analysis_compressed_all_unvoiced_raises(wav_file, epochs):
    """The constant-rate f0 interpolation of an all-unvoiced utterance
    indexes an empty array in both packages (the reference's own
    behaviour)."""
    kw = dict(b_const_rate=True, pm_sec=epochs[0],
              voi=np.zeros_like(epochs[1]))
    with pytest.raises(IndexError):
        jc.analysis_compressed(wav_file, **kw)
    with pytest.raises(IndexError):
        tc.analysis_compressed(wav_file, **kw, **CPU)


def test_format_for_modelling_fbank_matches_jax():
    """format_for_modelling(b_mag_fbank_mel=True) on random lossless
    streams: the filter-bank warp of mag, as the JAX package computes it
    (within 5e-5; measured 4.2e-7)."""
    rng = np.random.default_rng(0)
    n, h = 40, 2049
    mag = np.exp(rng.standard_normal((n, h))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (n, h))
    f0 = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(80, 250, n))
    args = (mag, np.cos(ang), np.sin(ang), f0, FS)
    ref = jc.format_for_modelling(*args, b_mag_fbank_mel=True)
    got = tc.format_for_modelling(*args, b_mag_fbank_mel=True, **CPU)
    for i in range(3):
        np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=5e-5)
    np.testing.assert_array_equal(got[3], ref[3])


def test_analysis_for_acoustic_modelling_files_match_jax(wav_file, epochs,
                                                         tmp_path):
    """The feature files of both packages: the same names, the same
    shapes, values within the analysis bounds."""
    kw = dict(mag_dim=60, phase_dim=45, pm_sec=epochs[0], voi=epochs[1])
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jc.analysis_for_acoustic_modelling(wav_file, str(tmp_path / "j"), **kw)
    tc.analysis_for_acoustic_modelling(wav_file, str(tmp_path / "t"), **kw,
                                       **CPU)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) == [
        "utt.imag", "utt.lf0", "utt.mag", "utt.real", "utt.shift"]
    for name, dim in zip(names, (45, 1, 60, 45, 1)):
        ref = tfeat.read_binfile(str(tmp_path / "j" / name), dim=dim)
        got = tfeat.read_binfile(str(tmp_path / "t" / name), dim=dim)
        tol = TOL_MEL if dim > 1 else 0.0
        np.testing.assert_allclose(got, ref, rtol=TOL_LF0_REL, atol=tol)


# ---------------------------------------------------------------------------
# compressed synthesis

@pytest.fixture(scope="module")
def feats(wav_file, epochs):
    """The JAX package's compressed features, per (const rate, fbank)."""
    return {(cr, fb): jc.analysis_compressed(
        wav_file, mag_dim=60, phase_dim=45, b_const_rate=cr,
        b_mag_fbank_mel=fb, pm_sec=epochs[0], voi=epochs[1])
        for cr in (False, True) for fb in (False, True)}


@pytest.mark.parametrize("case", [
    dict(), dict(b_out_hpf=False), dict(per_phase_type="min_phase"),
    dict(per_phase_type="min_phase", b_out_hpf=False),
    dict(b_const_rate=True), dict(b_fbank_mel=True),
    dict(b_const_rate=True, b_fbank_mel=True, b_out_hpf=False)], ids=str)
def test_synthesis_from_compressed_matches_jax(feats, case):
    """The same features and key through both packages: the waveform
    within TOL_WAV of its peak, the same length."""
    f = feats[(case.get("b_const_rate", False),
               case.get("b_fbank_mel", False))]
    key = prng_key(5)
    ref = jc.synthesis_from_compressed(*f[:4], FS, key=key, **case)
    got = tc.synthesis_from_compressed(*f[:4], FS, key=key, **case, **CPU)
    _assert_wav_close(got, ref)


def test_synthesis_default_key_is_prng_key_0(feats):
    f = feats[(False, False)]
    np.testing.assert_array_equal(
        tc.synthesis_from_compressed(*f[:4], FS, **CPU),
        tc.synthesis_from_compressed(*f[:4], FS, key=prng_key(0), **CPU))


def test_synthesis_from_acoustic_modelling_matches_jax(feats, tmp_path):
    """Feature files in, post-filtered ('magphase') synthesis, a
    peak-normalised PCM16 wav out: the two wavs within one PCM16 step
    (float values that differ by round-off may round to neighbouring
    steps; measured one step)."""
    f = feats[(False, False)]
    for ext, a in zip((".mag", ".real", ".imag", ".lf0"), f[:4]):
        tfeat.write_featfile(a, str(tmp_path), "tok" + ext)
    for pkg, d in ((jc, "j"), (tc, "t")):
        (tmp_path / d).mkdir()
        kw = CPU if pkg is tc else {}
        pkg.synthesis_from_acoustic_modelling(
            str(tmp_path), "tok", str(tmp_path / d), 60, 45, FS,
            pf_type="magphase", key=prng_key(2), **kw)
    ref, fs_r = twav.read_wav(str(tmp_path / "j" / "tok.wav"))
    got, fs_g = twav.read_wav(str(tmp_path / "t" / "tok.wav"))
    assert fs_r == fs_g == FS and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -15)


def test_batch_equals_single(feats):
    """synthesis_from_compressed_batch(key=k) utterance i against the single
    entry given split(k, n)[i], without the output high-pass (the batch's
    is spectral, the single entry's the host IIR): within 2e-4 absolute,
    the JAX package's own bound (tests/test_parallel.py; measured
    1.2e-7)."""
    utts = [feats[(False, False)][:4], feats[(True, False)][:4]]
    key = prng_key(3)
    outs = tbatch.synthesis_from_compressed_batch(utts, FS, key=key,
                                                  b_out_hpf=False, **CPU)
    keys = split(key, len(utts))
    for i, u in enumerate(utts):
        single = tc.synthesis_from_compressed(*u, FS, b_out_hpf=False,
                                              key=keys[i], **CPU)
        assert outs[i].shape == single.shape
        np.testing.assert_allclose(outs[i], single, rtol=0, atol=2e-4)


def _core_inputs(rng, F=16, nfrms=13, fft_len=1024):
    h = fft_len // 2 + 1
    shifts = rng.integers(150, 300, F).astype(np.int32)
    pm = np.cumsum(shifts).astype(np.int32)
    ns_len = int(pm[nfrms - 1] + shifts[nfrms - 1])
    t = lambda a: torch.from_numpy(np.asarray(a))[None]
    mag = np.exp(rng.standard_normal((F, h))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (F, h))
    return (t(mag), t(np.cos(ang).astype(np.float32)),
            t(np.sin(ang).astype(np.float32)),
            t((rng.random(F) < 0.6).astype(np.float32)), t(pm), t(shifts),
            torch.tensor([nfrms]), torch.tensor([ns_len]),
            torch.tensor([[7, 11]], dtype=torch.int64)), ns_len


def test_synthesis_core_batch_takes_ns_len_max():
    """synthesis_core_batch takes the JAX keyword ns_len_max (the noise
    buffer's bucket there); the noise is a function of the absolute sample
    index, so two values give bitwise the same output, and so does the
    single-utterance synthesis_core that passes it through."""
    args, ns_len = _core_inputs(np.random.default_rng(0))
    kw = dict(fs=FS, fft_len=1024, alpha=0.77, b_voi_ap_win=True,
              per_phase_type="magphase", out_len_max=8192)
    outs = [tc.synthesis_core_batch(*args, ns_len_max=n, **kw)
            for n in (ns_len, 1 << 16)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    one = tc.synthesis_core(*(a[0] for a in args[:6]), args[6][0],
                            args[7][0], args[8][0].numpy().astype(np.uint32),
                            ns_len_max=1 << 14, **kw, **CPU)
    torch.testing.assert_close(one, outs[0][0], rtol=0, atol=0)


def test_hash_noise_uniform_bitwise():
    keys = np.asarray([[0, 1], [0xDEADBEEF, 12345]], np.uint32)
    ref = np.asarray(jc.hash_noise_uniform(jax.numpy.asarray(keys), 4000))
    got = tc.hash_noise_uniform(keys, 4000, **CPU).numpy()
    np.testing.assert_array_equal(got, ref)


def test_phase_uncompress_type1_mcep_matches_jax():
    """Within 1e-5 of the peak (measured 3.6e-7)."""
    rng = np.random.default_rng(1)
    re, im = (rng.uniform(-1, 1, (20, 10)).astype(np.float32)
              for _ in range(2))
    ref = jc.phase_uncompress_type1_mcep(re, im, 0.77, 4096, FS)
    got = tc.phase_uncompress_type1_mcep(re, im, 0.77, 4096, FS, **CPU)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


# ---------------------------------------------------------------------------
# batched analysis at the constant frame rate

@pytest.fixture(scope="module")
def signals():
    return [make_stimulus(FS, MIXED, seed=1)[0],
            make_stimulus(FS, [(0.5, 90, 180)], seed=2)[0]]


def _assert_batch_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _assert_features_close(g, r)


def test_analysis_compressed_batch_const_rate_tracked_matches_jax(signals):
    """The tracked branch (tracker + K4, then K1) with b_const_rate: the
    streams on the 5 ms grid, shift the variable-rate track, float32
    output."""
    kw = dict(b_const_rate=True, feat_dtype=np.float32)
    ref = jab.analysis_compressed_batch(signals, FS, **kw)
    got = tab.analysis_compressed_batch(signals, FS, **kw, **CPU)
    assert all(g[0].shape[0] != len(g[4]) for g in got)
    _assert_batch_close(got, ref)


def test_const_resample_batch_matches_jax():
    """The batched resampler of phase 2 against the JAX vmap, on padded
    utterances of different lengths (one with tied voiced marks): streams
    within 1e-5, f0 within 1e-6 relative (both measured 0)."""
    rng = np.random.default_rng(2)
    B, F, fc_max, h = 3, 64, 128, 17
    pm = np.zeros((B, F), np.int32)
    f0 = np.zeros((B, F), np.float32)
    n = np.asarray([60, 41, 2], np.int32)
    for b in range(B):
        pm[b, :n[b]] = np.cumsum(rng.integers(120, 480, n[b]))
        f0[b, :n[b]] = np.where(rng.random(n[b]) < 0.4, 0.0,
                                rng.uniform(80, 300, n[b]))
    f0[1, 5:7] = [100.0, 140.0]
    pm[1, 6] = pm[1, 5]
    m = [rng.uniform(-1, 1, (B, F, h)).astype(np.float32) for _ in range(3)]
    ref = jab._const_resample_batch(*m, f0, pm, n, crs=240.0, fc_max=fc_max)
    got = tab._const_resample_batch(*(torch.from_numpy(a)
                                      for a in (*m, f0, pm, n)),
                                    crs=240.0, fc_max=fc_max)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


# ---------------------------------------------------------------------------
# the facade

@pytest.mark.parametrize("b_const_rate", [False, True],
                         ids=["variable", "const"])
def test_facade_round_trip_matches_jax(wav_file, b_const_rate):
    """The README quickstart: analyze (tracked epochs) then synthesize with
    the magphase post-filter, through both facades."""
    cfg = dict(fs=48000, mag_dim=60, phase_dim=45, pf_type="magphase",
               b_const_rate=b_const_rate)
    jv = jmodels.MagPhaseVocoder(**cfg)
    tv = tmodels.MagPhaseVocoder(**cfg, **CPU)
    assert tv.fft_len == jv.fft_len == 4096
    ref = jv.analyze(wav_file)
    got = tv.analyze(wav_file)
    _assert_features_close(got, ref)
    key = prng_key(1)
    _assert_wav_close(tv.synthesize(*ref, key=key),
                      jv.synthesize(*ref, key=key))


def test_facade_analyze_batch_const_rate_matches_jax(signals, epochs):
    """analyze_batch(epochs=...) with b_const_rate on the facade (the
    given-epochs branch, float32 output)."""
    eps = [epochs, (epochs[0][epochs[0] < 0.5], epochs[1][epochs[0] < 0.5])]
    cfg = dict(fs=48000, mag_dim=60, phase_dim=45, b_const_rate=True)
    ref = jmodels.MagPhaseVocoder(**cfg).analyze_batch(signals, epochs=eps)
    got = tmodels.MagPhaseVocoder(**cfg, **CPU).analyze_batch(signals,
                                                              epochs=eps)
    _assert_batch_close(got, ref)


def test_facade_refuses_a_mesh_and_conflicting_features():
    tv = tmodels.MagPhaseVocoder(**CPU)
    with pytest.raises(ValueError):
        tv.analyze_batch([np.zeros(4800)], mesh=object())
    with pytest.raises(ValueError):
        tv.synthesize_batch([], mesh=object())
    z = np.zeros((3, 60))
    with pytest.raises(ValueError):
        tv.synthesize(z, z, z, np.zeros(3), None, 16000)


# ---------------------------------------------------------------------------
# the API surface

SIGNATURE_PAIRS = [
    (jc.analysis_compressed, tc.analysis_compressed),
    (jc.analysis_for_acoustic_modelling, tc.analysis_for_acoustic_modelling),
    (jc.phase_uncompress_type1_mcep, tc.phase_uncompress_type1_mcep),
    (jc.hash_noise_uniform, tc.hash_noise_uniform),
    (jc.synthesis_core, tc.synthesis_core),
    (jc.synthesis_from_compressed, tc.synthesis_from_compressed),
    (jc.synthesis_from_acoustic_modelling,
     tc.synthesis_from_acoustic_modelling),
    (jinterp.interp_linear_axis0, tinterp.interp_linear_axis0),
    (jframing.frame_geometry, tframing.frame_geometry),
    (jframing.pitch_sync_frames, tframing.pitch_sync_frames),
    (jframing.ola_centered, tframing.ola_centered),
    (jab.analysis_compressed_batch, tab.analysis_compressed_batch),
] + [(getattr(jfr, n), getattr(tfr, n)) for n in (
    "shift_to_f0_np", "interp_from_variable_to_const_frm_rate",
    "interp_from_const_to_variable_rate", "const_rate_resample_core",
    "get_shifts_and_frm_locs_from_const_shifts", "to_constant_rate")
] + [(getattr(jfbank, n), getattr(tfbank, n)) for n in (
    "apply_fbank", "sp_mel_warp_fbank", "sp_mel_warp_fbank_2d",
    "unwarp_from_fbank", "sp_mel_unwarp_fbank", "unwarp_from_fbank_curve",
    "apply_fbank_curve")
] + [(getattr(jmodels.MagPhaseVocoder, n), getattr(tmodels.MagPhaseVocoder, n))
     for n in ("__init__", "analyze_lossless", "analyze", "extract_to_dir",
               "analyze_batch", "analyze_lossless_batch",
               "synthesize_lossless", "synthesize", "synthesize_batch",
               "synthesize_from_dir")]


@pytest.mark.parametrize("pair", SIGNATURE_PAIRS,
                         ids=lambda p: p[0].__qualname__)
def test_signature_matches_jax(pair):
    """The JAX parameters' names, kinds and defaults in the JAX order; the
    port adds only a keyword-only ``device`` (default "cuda"), and nothing
    where the function is host numpy."""
    ref, got = (inspect.signature(f).parameters for f in pair)
    extra = [n for n in got if n not in ref]
    assert extra in ([], ["device"])
    if extra:
        assert got["device"].kind == inspect.Parameter.KEYWORD_ONLY
        assert got["device"].default == "cuda"
    assert [n for n in got if n != "device"] == list(ref)
    for n, p in ref.items():
        assert (got[n].kind, got[n].default) == (p.kind, p.default), n


def test_synthesis_core_batch_signature_holds_jax_order():
    """synthesis_core_batch: the JAX parameters, ns_len_max included, in the
    JAX order and kinds; the port's own keyword ``tables`` (its constant
    tables, built once per request) comes last.  ns_len_max has a default
    here, since it changes nothing."""
    ref = inspect.signature(jc.synthesis_core_batch).parameters
    got = inspect.signature(tc.synthesis_core_batch).parameters
    assert list(got)[:len(ref)] == list(ref)
    assert list(got)[len(ref):] == ["tables"]
    for n, p in ref.items():
        assert got[n].kind == p.kind, n
        if n != "ns_len_max":
            assert got[n].default == p.default, n


def test_vocoder_exports_the_slice():
    """The JAX vocoder names this slice ports are exported by the port's
    vocoder package."""
    names = {"analysis_compressed", "analysis_for_acoustic_modelling",
             "format_for_modelling", "synthesis_from_compressed",
             "synthesis_from_acoustic_modelling",
             "phase_uncompress_type1_mcep",
             "get_num_full_mel_coeffs_from_num_phase_coeffs", "post_filter",
             "post_filter_merlin", "framerate"}
    assert names <= set(jvocoder.__all__)
    assert names <= set(tvocoder.__all__)
    for n in names:
        assert hasattr(tvocoder, n), n


def test_importing_the_facade_builds_no_kernel():
    """The facade's module loads no kernel library and imports no jax."""
    code = ("import sys\n"
            "import magphase_tpu_torch.models\n"
            "from magphase_tpu_torch.kernels import dft, framing, walk\n"
            "assert 'jax' not in sys.modules\n"
            "for m in (dft, framing, walk):\n"
            "    assert m._library.cache_info().currsize == 0, m.__name__\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
