"""The rest of the port's core/spectral.py, core/misc_dsp.py, the
post-filter revisions, the type-2 lossless analysis and the float64 host
path (vocoder/lossless_f64.py) against the JAX package, on seeded inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magphase_tpu.core import misc_dsp as jm
from magphase_tpu.core import spectral as js
from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu.vocoder import lossless as jl
from magphase_tpu.vocoder import lossless_f64 as jf64
from magphase_tpu.vocoder import postfilter as jpf
from magphase_tpu_torch.core import misc_dsp as tm
from magphase_tpu_torch.core import spectral as ts
from magphase_tpu_torch.vocoder import lossless as tl
from magphase_tpu_torch.vocoder import lossless_f64 as tf64
from magphase_tpu_torch.vocoder import postfilter as tpf

EPOCHS = "tests/data/epochs_48k.npz"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module")
def spectra():
    """Pitch-synchronous magnitude spectra (rows of 1025 bins) of 0.6 s of
    16 kHz make_stimulus speech, voiced and unvoiced, from its true
    epochs: the port's lossless analysis, on the CPU."""
    fs = 16000
    sig, gci = make_stimulus(fs, [(0.15, None, None), (0.45, 110, 170)],
                             seed=4)[:2]
    pm = np.r_[np.arange(80, 0.15 * fs, 80), np.round(gci * fs)[1:-1]]
    voi = (pm >= 0.15 * fs).astype(np.float64)
    return tl.analysis_with_del_comp_from_pm(sig, fs, pm, voi, fft_len=2048,
                                             device="cpu")[0]


# ---------------------------------------------------------------------------
# core/spectral.py

@pytest.mark.parametrize("data_type", ["mag", "magnitude", "phase", "zeros"])
def test_add_hermitian_half_matches_jax(data_type):
    """Pure data movement (and a sign): equal to the JAX package, bitwise."""
    x = _rng().standard_normal((5, 17)).astype(np.float32)
    got = ts.add_hermitian_half(_t(x), data_type).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(js.add_hermitian_half(jnp.asarray(x), data_type)))


def test_add_hermitian_half_complex_and_remove_match_jax():
    """'complex' mirrors the real part even and the imaginary part odd;
    remove_hermitian_half undoes the mirror: bitwise the JAX results."""
    r = _rng(1)
    z = (r.standard_normal((4, 9)) + 1j * r.standard_normal((4, 9))).astype(
        np.complex64)
    got = ts.add_hermitian_half(_t(z), "complex").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(js.add_hermitian_half(jnp.asarray(z), "complex")))
    np.testing.assert_array_equal(ts.remove_hermitian_half(_t(got)).numpy(),
                                  np.asarray(js.remove_hermitian_half(
                                      jnp.asarray(got))))
    with pytest.raises(ValueError):
        ts.add_hermitian_half(_t(z.real), "bogus")


def test_protected_log_np_matches_jax():
    x = np.array([[1.0, 0.0, -1.0, np.inf, 2.5e-300]])
    np.testing.assert_array_equal(ts.protected_log_np(x.copy()),
                                  js.protected_log_np(x.copy()))


def test_spectral_crossfade_matches_jax(spectra):
    """A windowed sum: within 2 float32 ulps of the larger input (XLA may
    fuse the multiply and the add)."""
    a = spectra[:10].astype(np.float32)
    b = spectra[10:20].astype(np.float32)
    got = ts.spectral_crossfade(_t(a), _t(b), 5000.0, 800.0, 16000).numpy()
    ref = np.asarray(js.spectral_crossfade(jnp.asarray(a), jnp.asarray(b),
                                           5000.0, 800.0, 16000))
    assert np.all(np.abs(got - ref) <= 2.4e-7 * np.maximum(np.abs(a),
                                                           np.abs(b)))


def test_rceps_to_min_phase_rceps_matches_jax():
    """A copy with the interior doubled: bitwise."""
    x = _rng(2).standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        ts.rceps_to_min_phase_rceps(_t(x)).numpy(),
        np.asarray(js.rceps_to_min_phase_rceps(jnp.asarray(x))))


@pytest.mark.parametrize("nc_total,fade", [(60, 0.2), (40, 0.7), (100, 0.5)])
def test_spectral_smoothing_rceps_matches_jax(spectra, nc_total, fade):
    """The liftered log spectrum (values of tens of dB): within 2e-5 of
    the largest value, float32 FFT round-off of two FFT libraries over
    2048 points (measured 3e-6)."""
    x = (20.0 * np.log10(spectra[:40])).astype(np.float32)
    got = ts.spectral_smoothing_rceps(_t(x), nc_total, fade).numpy()
    ref = np.asarray(js.spectral_smoothing_rceps(jnp.asarray(x), nc_total,
                                                 fade))
    assert np.abs(got - ref).max() <= 2e-5 * np.abs(x).max()


def _freeze_iters(smooth, xp, m_db, ncoeffs, thres_db, n_maxiter):
    """The iteration at which each frame of true_envelope freezes
    (n_maxiter if never), replaying its loop with a package's own
    smoother."""
    v = m_db
    done = np.zeros(m_db.shape[0], bool)
    at = np.full(m_db.shape[0], n_maxiter)
    for i in range(n_maxiter):
        sm = np.asarray(smooth(xp(v), nc_total=ncoeffs, fade_to_total=0.7))
        err = np.mean(np.abs(np.asarray(v) - sm), axis=1)
        new = ~done & (err < thres_db)
        at[new] = i
        done |= new
        v = np.where(done[:, None], v, np.maximum(v, sm))
    return at


@pytest.mark.parametrize("in_type", ["abs", "db", "log"])
def test_true_envelope_matches_jax(spectra, in_type):
    """100 iterations with the per-frame freeze mask.  A frame freezes
    when its mean |spectrum - smoothed| falls below 0.1 dB, a decision
    round-off can flip: the frames whose freeze iteration differs between
    the two packages (replayed with each package's smoother) are counted
    and may be at most 10% of them (none measured; the frames freeze
    between iterations 12 and 21); on the others the envelopes agree
    within 5e-4 dB (float32 FFT round-off accumulated over 100
    iterations; measured 2.4e-5 dB).  The port's own freeze iterations
    (true_envelope_freeze) are its replay's."""
    m = spectra[:60].astype(np.float32)
    m_in = {"abs": m, "db": 20 * np.log10(m), "log": np.log(m)}[in_type]
    got = ts.true_envelope(_t(m_in), in_type=in_type, ncoeffs=60).numpy()
    ref = np.asarray(js.true_envelope(jnp.asarray(m_in), in_type=in_type,
                                      ncoeffs=60))

    def to_db(x):
        return {"abs": lambda y: 20 * np.log10(y), "db": lambda y: y,
                "log": lambda y: y * 20 / np.log(10)}[in_type](x)

    m_db = (20 * np.log10(m)).astype(np.float32)
    env, it_t = ts.true_envelope_freeze(_t(m_db), "db", ncoeffs=60)
    np.testing.assert_array_equal(it_t.numpy(), _freeze_iters(
        ts.spectral_smoothing_rceps, _t, m_db, 60, 0.1, 100))
    np.testing.assert_array_equal(env.numpy(), ts.true_envelope(
        _t(m_db), "db", ncoeffs=60).numpy())
    it_t = it_t.numpy()
    it_j = _freeze_iters(js.spectral_smoothing_rceps, jnp.asarray, m_db, 60,
                         0.1, 100)
    same = it_t == it_j
    assert np.count_nonzero(~same) <= 0.1 * len(m)
    assert len(np.unique(it_t)) > 2      # frames freeze at various points
    assert np.abs(to_db(got)[same] - to_db(ref)[same]).max() <= 5e-4


def test_get_rms_matches_jax(spectra):
    """A sum of squares per row: within 1e-6 relative (summation order)."""
    x = spectra[:20].astype(np.float32)
    got = ts.get_rms(_t(x), 2048).numpy()
    ref = np.asarray(js.get_rms(jnp.asarray(x), 2048))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# core/misc_dsp.py

def test_interp_unv_regions_matches_jax():
    """Linear and zeros modes, edge regions included: within 1 float32 ulp
    of the values (the same interpolation weights, computed apart)."""
    r = _rng(3)
    m = r.standard_normal((40, 6)).astype(np.float32)
    voi = (r.random(40) > 0.4).astype(np.float32)
    voi[:3] = 0
    voi[-4:] = 0
    for kind in ("linear", "zeros"):
        got = tm.interp_unv_regions(_t(m), _t(voi), kind).numpy()
        ref = np.asarray(jm.interp_unv_regions(jnp.asarray(m),
                                               jnp.asarray(voi), kind))
        np.testing.assert_allclose(got, ref, rtol=0, atol=4e-7)


def test_smooth_by_conv_and_windowing_match_jax():
    r = _rng(4)
    m = r.standard_normal((50, 3)).astype(np.float32)
    got = tm.smooth_by_conv(_t(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.smooth_by_conv(
        jnp.asarray(m))), rtol=0, atol=1e-6)
    v = r.standard_normal(1000).astype(np.float32)
    for ext in ("none", "both", "beg", "end"):
        got = tm.windowing_const_rate(_t(v), 64, 16, extend=ext).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jm.windowing_const_rate(jnp.asarray(v), 64, 16, extend=ext)))
    with pytest.raises(ValueError):
        tm.smooth_by_conv(_t(m), np.ones(4))


def test_mcep_to_lin_sp_log_matches_jax():
    m = _rng(5).standard_normal((7, 30)).astype(np.float32) * 0.1
    got = tm.mcep_to_lin_sp_log(_t(m), 256).numpy()
    ref = np.asarray(jm.mcep_to_lin_sp_log(jnp.asarray(m), 256))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_masks_and_phase_codes_match_jax():
    """The aperiodicity masks, the simple mask, the mix and the phase
    (sin, cos) codes: within 1e-6 (float32 elementwise math)."""
    r = _rng(6)
    voi = (r.random(30) > 0.5).astype(np.float32)
    for name in ("get_ap_mask_from_uv_decision",):
        got = getattr(tm, name)(voi, 512, 16000, 4000.0).numpy()
        ref = np.asarray(getattr(jm, name)(voi, 512, 16000, 4000.0))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    ph = r.uniform(-0.5, 0.5, (30, 20)).astype(np.float32)
    got = tm.estim_ap_mask_from_ph_data(ph, 512, 16000, 4000.0).numpy()
    ref = np.asarray(jm.estim_ap_mask_from_ph_data(ph, 512, 16000, 4000.0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    got = tm.gen_mask_simple(voi, 40, 25).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.gen_mask_simple(
        voi, 40, 25)))
    a, b = r.standard_normal((2, 30, 40)).astype(np.float32)
    np.testing.assert_allclose(tm.mix_by_mask(a, b, got).numpy(),
                               np.asarray(jm.mix_by_mask(a, b, got)),
                               rtol=0, atol=1e-6)
    s, c = tm.ph_enc(_t(ph * 6))
    js_, jc = jm.ph_enc(jnp.asarray(ph * 6))
    np.testing.assert_allclose(s.numpy(), np.asarray(js_), atol=1e-6)
    for mode in ("angle", "sign"):
        np.testing.assert_allclose(
            tm.ph_dec(s, c, mode).numpy(),
            np.asarray(jm.ph_dec(js_, jc, mode)), rtol=0, atol=2e-6)


def test_host_helpers_match_jax():
    """The numpy helpers are the JAX package's, value for value."""
    np.testing.assert_array_equal(tm.cos_win(33), jm.cos_win(33))
    np.testing.assert_array_equal(tm.win_squared(37), jm.win_squared(37))
    np.testing.assert_array_equal(tm.hz_to_bin([100.0, 7000.0], 1024, 16000),
                                  jm.hz_to_bin([100.0, 7000.0], 1024, 16000))
    np.testing.assert_array_equal(tm.bin_to_hz([3, 300], 1024, 16000),
                                  jm.bin_to_hz([3, 300], 1024, 16000))
    for x in (0, 1, 3, 1024, 1025):
        assert tm.next_pow_of_two(x) == jm.next_pow_of_two(x)
    assert tm.get_n_frames_from_sig_len(48000, 5.0, 48000) == \
        jm.get_n_frames_from_sig_len(48000, 5.0, 48000)
    np.testing.assert_array_equal(tm.frame_shift([1.0, 2.0], 3, 8),
                                  jm.frame_shift([1.0, 2.0], 3, 8))


# ---------------------------------------------------------------------------
# post-filters, type-2 analysis, float64 host path

def test_post_filter_revisions_match_jax():
    """post_filter_dev (and its residual) and post_filter_backup_old: the
    same matmul and tilt, within 1e-5 on log magnitudes of ~|5|."""
    m = (_rng(7).standard_normal((30, 60)) - 3.0).astype(np.float32)
    enh, norm = tpf.post_filter_dev(_t(m), 48000)
    renh, rnorm = jpf.post_filter_dev(jnp.asarray(m), 48000)
    np.testing.assert_allclose(enh.numpy(), np.asarray(renh), atol=1e-5)
    np.testing.assert_allclose(norm.numpy(), np.asarray(rnorm), atol=1e-5)
    np.testing.assert_allclose(
        tpf.post_filter_backup_old(_t(m)).numpy(),
        np.asarray(jpf.post_filter_backup_old(jnp.asarray(m))), atol=1e-5)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_analysis_type2_matches_jax(fs):
    """Features, shifts, f0 and the per-frame gain of the type-2 analysis
    from true epochs (unvoiced marks every 5 ms before the voiced run):
    magnitudes within 1e-5 of the peak and phasors within 1e-4 where the
    bin is above 1e-3 of the peak (FFT round-off; the bounds of
    test_torch_lossless.py), shifts and f0 equal, gains within 1e-5
    relative (the unvoiced std is a difference of sums over a frame, in
    another order)."""
    sig, gci = make_stimulus(fs, [(0.1, None, None), (0.4, 100, 160)],
                             seed=5)[:2]
    pm = np.r_[np.arange(fs // 200, 0.1 * fs, fs // 200),
               np.round(gci * fs)[1:-1]]
    voi = (pm >= 0.1 * fs).astype(np.float64)
    got = tl.analysis_with_del_comp_from_pm_type2(sig, fs, pm, voi,
                                                  device="cpu")
    ref = jl.analysis_with_del_comp_from_pm_type2(sig, fs, pm, voi)
    mag, real, imag, f0, shift, gain = got
    assert np.abs(mag - ref[0]).max() <= 1e-5 * ref[0].max()
    big = ref[0] > 1e-3 * ref[0].max()
    assert np.abs(real - ref[1])[big].max() <= 1e-4
    assert np.abs(imag - ref[2])[big].max() <= 1e-4
    np.testing.assert_array_equal(f0, ref[3])
    np.testing.assert_array_equal(shift, ref[4])
    np.testing.assert_allclose(gain, ref[5], rtol=1e-5, atol=1e-9)
    assert np.all(gain[voi > 0] > 0)


def test_lossless_f64_is_the_jax_module_bitwise():
    """The float64 host path is a numpy copy: analysis features, the
    resynthesis and the copy-synthesis round trip equal the JAX module's
    bit for bit, on recorded 48 kHz epochs with a synthetic signal."""
    ep = np.load(EPOCHS)
    pm = ep["hvd_593_pm"][:120]
    voi = ep["hvd_593_voi"][:120]
    fs = 48000
    sig = make_stimulus(fs, [(pm[-1] + 0.05, 110, 150)], seed=6)[0]
    got = tf64.analysis_lossless_f64(sig, fs, pm, voi)
    ref = jf64.analysis_lossless_f64(sig, fs, pm, voi)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(
        tf64.synthesis_from_lossless_f64(*got[:4], fs),
        jf64.synthesis_from_lossless_f64(*ref[:4], fs))
    np.testing.assert_array_equal(tf64.copy_synthesis_f64(sig, fs, pm, voi),
                                  jf64.copy_synthesis_f64(sig, fs, pm, voi))
