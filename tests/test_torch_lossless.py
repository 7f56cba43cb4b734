"""Lossless copy-synthesis of the port against the JAX package: the host
API of vocoder/lossless.py, analysis_lossless_batch in both branches and
all three transports, copy_synthesis_batch, the wav/est/featfile I/O, and
the guards on the options the port refuses.

Inputs: synthetic speech from make_stimulus (<= 1 s at 48 kHz) and the
recorded epochs of tests/data/epochs_48k.npz for real mark geometry.
Bounds (measured values in each docstring): the two packages' float32
FFTs round differently (pocketfft in torch, XLA's on the CPU), so spectra
agree to ~2e-7 of their peak and phasors to round-off where the bin is
not near zero; marks, shifts and f0 agree exactly.
"""
import inspect
import os

import numpy as np
import pytest
import torch

from magphase_tpu import io as jio
from magphase_tpu.parallel import analysis_batch as jab
from magphase_tpu.parallel import copy_synthesis as jcs
from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu.vocoder import lossless as jl
from magphase_tpu_torch import io as tio
from magphase_tpu_torch import vocoder as tvocoder
from magphase_tpu_torch.parallel import analysis_batch as tab
from magphase_tpu_torch.parallel import copy_synthesis as tcs
from magphase_tpu_torch.vocoder import lossless as tl

FS = 48000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXED = [(0.2, None, None), (0.3, 140, 200), (0.15, None, None),
         (0.25, 220, 110), (0.1, None, None)]
PCM16_STEP = 2.0 ** -15
TOL_MAG_REL = 1e-5          # magnitudes, of the peak (measured 1.8e-7)
TOL_PHASOR = 1e-4           # phasors where mag > 1e-3 of the peak
                            # (measured 5.0e-5)
LSB = np.pi / 32768.0       # one step of the int16 angle


def _signals():
    return [make_stimulus(FS, MIXED, seed=1)[0],
            make_stimulus(FS, [(0.6, 90, 180)], seed=2)[0]]


def _epochs(tok, seconds):
    """Recorded marks (s) and voicing of one utterance, cut to ``seconds``."""
    d = np.load(os.path.join(REPO, "tests", "data", "epochs_48k.npz"))
    pm, voi = d[f"{tok}_pm"], d[f"{tok}_voi"]
    keep = pm < seconds
    return pm[keep], voi[keep]


def _assert_features_close(got, ref, exact_phasor_bound=TOL_PHASOR):
    """(mag, real, imag, f0, shift) tuples: shapes and dtypes equal, shift
    and f0 equal, mag within TOL_MAG_REL of the peak, the phasor within
    ``exact_phasor_bound`` where mag > 1e-3 of the peak."""
    for g, r in zip(got, ref):
        assert [a.shape for a in g] == [b.shape for b in r]
        assert [a.dtype for a in g] == [b.dtype for b in r]
        np.testing.assert_array_equal(g[4], r[4])
        np.testing.assert_array_equal(g[3], r[3])
        peak = np.abs(r[0]).max()
        np.testing.assert_allclose(g[0], r[0], rtol=0,
                                   atol=TOL_MAG_REL * peak)
        big = r[0] > 1e-3 * peak
        for i in (1, 2):
            np.testing.assert_allclose(g[i][big], r[i][big], rtol=0,
                                       atol=exact_phasor_bound)


def _p99(syn, sig):
    n = min(len(syn), len(sig))
    return float(np.percentile(np.abs(syn[2000:n - 2000]
                                      - sig[2000:n - 2000]), 99))


# ---------------------------------------------------------------------------
# host API

@pytest.mark.parametrize("nwin", [0.5, 1.0, 2.0])
def test_densify_pitch_marks_matches_jax(nwin):
    """Recorded marks with voicing: the densified marks and voicing equal
    the JAX package's exactly (numpy on both sides)."""
    pm, voi = _epochs("hvd_593", 3.0)
    got = tl.densify_pitch_marks(pm * FS, nwin, voi)
    ref = jl.densify_pitch_marks(pm * FS, nwin, voi)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(tl.densify_pitch_marks(pm * FS, nwin)[0],
                                  ref[0])


def test_densify_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError):
        tl.densify_pitch_marks(np.arange(10.0), 0.7)


@pytest.mark.parametrize("nwin", [0.5, 1.0])
def test_analysis_with_del_comp_from_pm_matches_jax(nwin):
    """One utterance from recorded marks: shift and f0 equal, mag to 1e-5
    of the peak, the phasor to 1e-4 where the bin is above 1e-3 of the
    peak (float32 FFT round-off between the two packages)."""
    sig = make_stimulus(FS, MIXED, seed=3)[0]
    pm, voi = _epochs("hvd_594", len(sig) / FS - 0.01)
    args = (sig, FS, pm * FS, voi)
    got = tl.analysis_with_del_comp_from_pm(*args, nwin_per_pitch_period=nwin,
                                            device="cpu")
    ref = jl.analysis_with_del_comp_from_pm(*args,
                                            nwin_per_pitch_period=nwin)
    assert got[0].shape[1] == 2049
    _assert_features_close([got], [ref])


@pytest.fixture(scope="module")
def lossless_feats():
    """JAX lossless features of one utterance from recorded marks."""
    sig = make_stimulus(FS, MIXED, seed=4)[0]
    pm, voi = _epochs("hvd_595", len(sig) / FS - 0.01)
    return sig, jl.analysis_with_del_comp_from_pm(sig, FS, pm * FS, voi)


def test_synthesis_from_lossless_matches_jax(lossless_feats):
    """The same float64 features through both packages' synthesis: equal
    length, samples within 1e-6 (measured 1.2e-7: float32 irfft round-off),
    and the input reconstructed at p99 < 2^-15."""
    sig, (mag, real, imag, f0, _shift) = lossless_feats
    got = tl.synthesis_from_lossless(mag, real, imag, f0, FS, device="cpu")
    ref = jl.synthesis_from_lossless(mag, real, imag, f0, FS)
    assert got.dtype == np.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert _p99(got, sig) < PCM16_STEP


def test_synthesis_with_del_comp_matches_jax(lossless_feats):
    """The legacy magnitude + phase synthesis: the host irfft is the same
    numpy call in both packages and the OLA is K2's plain version, so the
    samples agree to float32 summation order (bound 1e-6, measured below
    1e-7); the dead window-correction branch raises in both."""
    _sig, (mag, real, imag, _f0, shift) = lossless_feats
    ph = np.arctan2(imag, real)
    got = tl.synthesis_with_del_comp(mag, ph, shift, device="cpu")
    ref = jl.synthesis_with_del_comp(mag, ph, shift)
    assert got.shape == ref.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError):
        tl.synthesis_with_del_comp(mag, ph, shift, win_flat_to_len=0.3,
                                   device="cpu")


def test_shift_helpers_match_jax():
    """f0_to_shift, shift_to_pm and pm_to_shift equal the JAX package's."""
    f0 = np.asarray([0.0, 120.0, 200.0, 0.0, 96.0])
    np.testing.assert_array_equal(tl.f0_to_shift(f0, FS),
                                  jl.f0_to_shift(f0, FS))
    sh = np.asarray([240, 400, 240, 500])
    np.testing.assert_array_equal(tl.shift_to_pm(sh), jl.shift_to_pm(sh))
    np.testing.assert_array_equal(tl.pm_to_shift(np.cumsum(sh)),
                                  jl.pm_to_shift(np.cumsum(sh)))


@pytest.mark.parametrize("epochs_from", ["est_file", "pm_sec", "tracker"])
def test_analysis_lossless_through_files_matches_jax(tmp_path, epochs_from):
    """analysis_lossless from a PCM16 wav (and a REAPER est file, explicit
    marks or the built-in tracker) with out_dir: the .shift and .f0
    featfiles are byte-identical to the JAX package's, the .mag, .real and
    .imag files agree to the FFT round-off bounds above."""
    sig = make_stimulus(FS, MIXED, seed=5)[0]
    wav = str(tmp_path / "utt.wav")
    tio.write_wav(wav, 0.9 * sig / np.abs(sig).max(), FS)
    pm, voi = _epochs("hvd_596", len(sig) / FS - 0.01)
    kw = {}
    if epochs_from == "est_file":
        kw["est_file"] = str(tmp_path / "utt.est")
        tio.write_reaper_est_file(kw["est_file"], pm, voi)
    elif epochs_from == "pm_sec":
        kw = dict(pm_sec=pm, voi=voi)
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    out_t.mkdir()
    out_j.mkdir()
    assert tl.analysis_lossless(wav, out_dir=str(out_t), device="cpu",
                                **kw) is None
    assert jl.analysis_lossless(wav, out_dir=str(out_j), **kw) is None
    for ext in ("shift", "f0"):
        assert (out_t / f"utt.{ext}").read_bytes() == \
            (out_j / f"utt.{ext}").read_bytes()
    got = [tio.read_binfile(str(out_t / f"utt.{e}"), dim=2049)
           for e in ("mag", "real", "imag")]
    ref = [jio.read_binfile(str(out_j / f"utt.{e}"), dim=2049)
           for e in ("mag", "real", "imag")]
    f0 = tio.read_binfile(str(out_t / "utt.f0"), dim=1)
    sh = tio.read_binfile(str(out_t / "utt.shift"), dim=1)
    _assert_features_close([got + [f0, sh]], [ref + [f0, sh]])
    res = tl.analysis_lossless(wav, device="cpu", **kw)
    assert res[4] == FS and res[0].shape == got[0].shape


# ---------------------------------------------------------------------------
# analysis_lossless_batch

def test_analysis_lossless_batch_given_epochs_matches_jax():
    """The given-epochs branch, two utterances of unequal length: shift and
    f0 equal, features within the FFT round-off bounds."""
    sigs = _signals()
    eps = [_epochs("hvd_593", len(s) / FS - 0.01) for s in sigs]
    got = tab.analysis_lossless_batch(sigs, FS, epochs=eps, device="cpu")
    ref = jab.analysis_lossless_batch(sigs, FS, epochs=eps)
    assert got[0][0].dtype == np.float32
    _assert_features_close(got, ref)


@pytest.fixture(scope="module")
def tracked():
    """The JAX tracked lossless features of _signals() per transport."""
    sigs = _signals()
    return sigs, {tr: jab.analysis_lossless_batch(sigs, FS, transport=tr)
                  for tr in tab.TRANSPORTS}


def test_analysis_lossless_batch_tracked_f32_matches_jax(tracked):
    """The tracker branch, exact transport: the same marks (shift, f0
    equal), features within the FFT round-off bounds."""
    sigs, ref = tracked
    got = tab.analysis_lossless_batch(sigs, FS, device="cpu")
    _assert_features_close(got, ref["f32"])


def _angle_lsb_error(g, r):
    """Largest angle difference of the decoded phasors, where the bin is
    above 1e-3 of the peak, as int16 angle steps."""
    peak = np.abs(r[0]).max()
    big = r[0] > 1e-3 * peak
    d = np.angle(np.exp(1j * (np.arctan2(g[2], g[1])
                              - np.arctan2(r[2], r[1]))))
    return float(np.abs(d[big]).max())


@pytest.mark.parametrize("transport", ["compact", "compact16"])
def test_analysis_lossless_batch_compact_transports_match_jax(tracked,
                                                              transport):
    """The int16-angle transports: shift and f0 equal; the decoded angle
    within one int16 step (pi/32768) of the JAX package's where the bin is
    above 1e-3 of the peak, plus 1e-6 rad of float32 decode round-off
    (measured 1.002 steps: rounding at a half step can go either way);
    'compact' mag as the exact transport's; 'compact16' mag within one
    affine step of its (utterance, bin) plus the FFT bound (measured 1.8
    steps without it).  Each decoded feature set resynthesises its input
    at p99 < 2^-15 (measured <= 9.7e-6)."""
    sigs, ref = tracked
    got = tab.analysis_lossless_batch(sigs, FS, transport=transport,
                                      device="cpu")
    for sig, g, r in zip(sigs, got, ref[transport]):
        assert [a.dtype for a in g] == [b.dtype for b in r]
        np.testing.assert_array_equal(g[4], r[4])
        np.testing.assert_array_equal(g[3], r[3])
        assert _angle_lsb_error(g, r) <= LSB + 1e-6
        norm = g[1].astype(np.float64) ** 2 + g[2].astype(np.float64) ** 2
        assert np.abs(norm[g[0] > 0] - 1.0).max() < 1e-6
        peak = np.abs(r[0]).max()
        if transport == "compact":
            np.testing.assert_allclose(g[0], r[0], rtol=0,
                                       atol=TOL_MAG_REL * peak)
        else:
            step = (r[0].max(0) - r[0].min(0)) / 65535.0
            assert np.all(np.abs(g[0] - r[0])
                          <= step[None, :] + TOL_MAG_REL * peak)
        syn = tl.synthesis_from_lossless(*(a.astype(np.float64)
                                           for a in g[:3]), g[3], FS,
                                         device="cpu")
        assert _p99(syn, sig) < PCM16_STEP


def test_compact_transport_keeps_silent_bins_silent():
    """A digitally silent tail gives mag == 0 bins; the int16-angle decode
    keeps their phasor (0, 0), as the exact transport stores it."""
    sig = np.concatenate([make_stimulus(FS, [(0.4, 150, 150)], seed=6)[0],
                          np.zeros(24000)])
    (mag, real, imag, _f0, _sh), = tab.analysis_lossless_batch(
        [sig], FS, transport="compact", device="cpu")
    z = mag == 0.0
    assert z.any()
    assert np.all(real[z] == 0.0) and np.all(imag[z] == 0.0)


def test_lossless_capacity_fallback_matches_jax(monkeypatch):
    """A walk capacity below the mark count redoes the utterance with the
    host walk and the given-epochs branch in both packages; the port
    counts it in analysis_batch.capacity_fallbacks."""
    sigs = _signals()[:1]
    monkeypatch.setattr(jab, "placement_m_max", lambda *a: 128)
    monkeypatch.setattr(tab, "placement_m_max", lambda *a: 128)
    ref = jab.analysis_lossless_batch(sigs, FS, fft_len=2048)
    before = tab.capacity_fallbacks
    got = tab.analysis_lossless_batch(sigs, FS, fft_len=2048, device="cpu")
    assert tab.capacity_fallbacks == before + 1
    assert len(got[0][4]) > 128
    _assert_features_close(got, ref)


# ---------------------------------------------------------------------------
# copy_synthesis_batch

@pytest.fixture(scope="module")
def copy_ref():
    sigs = _signals()
    return sigs, jcs.copy_synthesis_batch(sigs, FS)


def test_copy_synthesis_batch_matches_jax(copy_ref):
    """Wav in, wav out: each output as long as its input, within 2e-6 of
    the JAX package's (measured 1.5e-7: the same tracked marks, float32 FFT
    round-off), and reconstructing its input at p99 < 2^-15 (measured
    5.3e-8 and 6.1e-8)."""
    sigs, ref = copy_ref
    got = tcs.copy_synthesis_batch(sigs, FS, device="cpu")
    for sig, g, r in zip(sigs, got, ref):
        assert g.dtype == np.float64 and g.shape == r.shape == sig.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-6)
        assert _p99(g, sig) < PCM16_STEP


def test_copy_synthesis_phase2_at_the_realised_bucket_is_unchanged():
    """The port runs the analysis and synthesis at the realised frame bucket
    where the JAX program runs them at the walk capacity m_max: on the same
    device the two give bitwise the same samples, because the OLA adds only
    frames below each utterance's mark count."""
    sigs = _signals()
    _, (s, ns, nf), S, Tmax, m_max, _ = tab._host_signal_batch(sigs, FS)
    s, ns, nf = (torch.from_numpy(a) for a in (s, ns, nf))
    kw = dict(fs=FS, n_frames_max=Tmax, m_max=m_max, fft_len=4096,
              out_len_max=S + (1 << 14))
    bufs, n_marks, nm = tcs._copy_synthesis_impl(s, ns, nf, **kw)
    assert int(nm.max()) < 512 < m_max
    marks, flags, n_marks2 = tcs.track_and_place_batch(
        s, ns, nf, fs=FS, n_frames_max=Tmax, m_max=m_max)
    mag, real, imag, _f0, _sh = tl.analysis_core_batch(
        s, marks, n_marks2, ns, flags, fft_len=4096, fs=FS)
    full = tl.synthesis_core_batch(mag, real, imag, marks, n_marks2,
                                   fft_len=4096, out_len_max=kw["out_len_max"])
    assert torch.equal(n_marks, n_marks2)
    assert torch.equal(bufs, full)


def test_copy_synthesis_budget_split_and_device_buffers(copy_ref,
                                                        monkeypatch):
    """Under a budget of one utterance per group the request splits into
    sequential groups with the same samples as one group (bound 1e-7: only
    the batched FFTs' row counts change); block_result=False gives the
    device rows and mark counts, whose rows start with the samples."""
    sigs, _ = copy_ref
    whole = tcs.copy_synthesis_batch(sigs, FS, device="cpu")
    rows, n_marks = tcs.copy_synthesis_batch(sigs, FS, block_result=False,
                                             device="cpu")
    assert rows.shape[0] == 8 and n_marks.shape == (8,)
    for b, w in enumerate(whole):
        np.testing.assert_array_equal(
            rows[b, :len(w)].numpy().astype(np.float64), w)
    S, m_max, _ = tab._budget_geometry(sigs, FS, 4096)
    monkeypatch.setattr(tab, "MAX_FRAME_ELEMS", m_max * 4096)
    split = tcs.copy_synthesis_batch(sigs, FS, device="cpu")
    rows_s, nms = tcs.copy_synthesis_batch(sigs, FS, block_result=False,
                                           device="cpu")
    assert len(rows_s) == len(nms) == 2
    for w, s, n in zip(whole, split, nms):
        np.testing.assert_allclose(s, w, rtol=0, atol=1e-7)
        assert int(n) > 0


# ---------------------------------------------------------------------------
# I/O

@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_wav_io_matches_jax(tmp_path, subtype):
    """write_wav gives the JAX package's bytes; read_wav, read_wav_info and
    read_audio_file read them to the same values; write_audio_file peak-
    normalises as the reference does."""
    x = 0.4 * np.sin(np.arange(4000) * 0.01)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    tio.write_wav(a, x, FS, subtype=subtype)
    jio.write_wav(b, x, FS, subtype=subtype)
    assert open(a, "rb").read() == open(b, "rb").read()
    got, fs = tio.read_wav(a)
    ref, _ = jio.read_wav(a)
    assert fs == FS
    np.testing.assert_array_equal(got, ref)
    assert tio.read_wav_info(a) == jio.read_wav_info(a) == (4000, FS)
    np.testing.assert_array_equal(tio.read_audio_file(a)[0], ref)
    tio.write_audio_file(a, x, FS)
    jio.write_audio_file(b, x, FS)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_est_and_featfile_io_match_jax(tmp_path):
    """The REAPER est writer gives the JAX package's bytes; the reader
    drops non-monotonic marks and clips marks at the signal's end alike;
    featfiles round-trip byte for byte."""
    pm, voi = _epochs("hvd_597", 1.0)
    a, b = str(tmp_path / "a.est"), str(tmp_path / "b.est")
    tio.write_reaper_est_file(a, pm, voi)
    jio.write_reaper_est_file(b, pm, voi)
    assert open(a).read() == open(b).read()
    bad = np.concatenate([pm[:5], pm[3:4], pm[5:]])       # non-monotonic
    bad_v = np.concatenate([voi[:5], voi[3:4], voi[5:]])
    tio.write_reaper_est_file(a, bad, bad_v)
    for kw in ({}, dict(check_len_smpls=int(0.8 * FS), fs=FS)):
        got = tio.read_reaper_est_file(a, **kw)
        ref = jio.read_reaper_est_file(a, **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(tio.read_est_file(a), jio.read_est_file(a))
    with pytest.raises(ValueError):
        tio.read_reaper_est_file(a, check_len_smpls=100)
    m = np.random.default_rng(0).standard_normal((7, 5))
    tio.write_featfile(m, str(tmp_path), "x.mag")
    jio.write_featfile(m, str(tmp_path), "y.mag")
    assert (tmp_path / "x.mag").read_bytes() == \
        (tmp_path / "y.mag").read_bytes()
    np.testing.assert_array_equal(
        tio.read_binfile(str(tmp_path / "x.mag"), dim=5),
        jio.read_binfile(str(tmp_path / "x.mag"), dim=5))


# ---------------------------------------------------------------------------
# guards

@pytest.mark.parametrize("bad", [dict(mesh=object()),
                                 dict(transport="f16"),
                                 dict(transport="compact", mesh=object())])
def test_lossless_batch_refuses_unported_options(bad):
    """A mesh and any transport outside f32/compact/compact16 raise
    ValueError up front, in both branches."""
    sigs = _signals()[:1]
    with pytest.raises(ValueError):
        tab.analysis_lossless_batch(sigs, FS, device="cpu", **bad)
    with pytest.raises(ValueError):
        tab.analysis_lossless_batch(sigs, FS, epochs=[_epochs("hvd_593",
                                                              0.9)],
                                    device="cpu", **bad)


def test_copy_synthesis_refuses_a_mesh():
    with pytest.raises(ValueError):
        tcs.copy_synthesis_batch(_signals()[:1], FS, mesh=object(),
                                 device="cpu")


def test_vocoder_exports_the_lossless_api():
    for name in ("analysis_lossless", "analysis_with_del_comp_from_pm",
                 "densify_pitch_marks", "synthesis_from_lossless",
                 "synthesis_with_del_comp", "f0_to_shift", "shift_to_pm",
                 "pm_to_shift"):
        assert getattr(tvocoder, name) is getattr(tl, name)
        assert set(inspect.signature(getattr(tl, name)).parameters) >= set(
            inspect.signature(getattr(jl, name)).parameters)


# ---------------------------------------------------------------------------
# on the card

@pytest.mark.cuda
def test_cuda_copy_synthesis_matches_cpu():
    """copy_synthesis_batch on the card against the CPU: where both place
    the same marks the waveforms agree within 1e-5 of the peak (cuFFT
    against pocketfft round-off), and each reconstructs its input at
    p99 < 2^-15."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sigs = _signals()
    gpu = tcs.copy_synthesis_batch(sigs, FS)
    cpu = tcs.copy_synthesis_batch(sigs, FS, device="cpu")
    for sig, g, c in zip(sigs, gpu, cpu):
        assert _p99(g, sig) < PCM16_STEP
    ref = tab.analysis_lossless_batch(sigs, FS, device="cpu")
    got = tab.analysis_lossless_batch(sigs, FS)
    for g, c, fr, fg in zip(gpu, cpu, ref, got):
        if np.array_equal(fr[4], fg[4]):
            assert np.abs(g - c).max() <= 1e-5 * np.abs(c).max()
