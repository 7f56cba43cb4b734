"""The port's core/filters.py against the JAX package and scipy: sosfilt
in both forms, lfilter, the elliptic and Butterworth designs, and the
blocked output high-pass of the batched synthesis
(MAGPHASE_HPF_MODE=blocked): the JAX package's audio, and each
utterance's samples independent of the batch it is in, byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sp

from magphase_tpu.core import filters as jf
from magphase_tpu.parallel import batch as jbatch
from magphase_tpu_torch.core import filters as tf
from magphase_tpu_torch.parallel import batch as tbatch
from magphase_tpu_torch.utils.keys import prng_key, split

FS = 48000
SOS = tf.butter_highpass_sos(4, 40.0, FS)


def _x(n, seed):
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


@pytest.mark.parametrize("mode", ["auto", "blocked"])
@pytest.mark.parametrize("n", [5000, 122880, 140000])
def test_sosfilt_matches_scipy_and_jax(n, mode):
    """Both convolution forms of the 40 Hz / 48 kHz high-pass against the
    float64 scipy recursion: within 1e-5, the JAX package's own bound
    (tests/test_filters.py; the trimmed impulse response drops a tail of
    ~4e-6); against the JAX package within 1e-6 (float32 FFT round-off of
    two FFT libraries, measured 1.3e-7).  n = 122880 takes the
    whole-signal form under 'auto', 140000 the blocked one."""
    x = _x(n, 3)
    got = tf.sosfilt(SOS, torch.from_numpy(x), mode=mode).numpy()
    ref = sp.sosfilt(np.asarray(SOS, np.float64), x.astype(np.float64))
    jx = np.asarray(jf.sosfilt(SOS, jnp.asarray(x), mode=mode))
    assert got.dtype == np.float32 and got.shape == (n,)
    assert np.abs(got - ref).max() < 1e-5
    assert np.abs(got - jx).max() < 1e-6


def test_sosfilt_rows_are_filtered_apart():
    """A (rows, n) tensor is filtered row by row: each row equals the 1-D
    call on it, bitwise (the CPU's FFT does not depend on the row count)."""
    x = np.stack([_x(70000, s) for s in range(3)])
    both = tf.sosfilt(SOS, torch.from_numpy(x), mode="blocked").numpy()
    for r in range(3):
        one = tf.sosfilt(SOS, torch.from_numpy(x[r]), mode="blocked").numpy()
        np.testing.assert_array_equal(both[r], one)


def test_blocked_sosfilt_ignores_the_padding():
    """mode='blocked': sample i depends on x[:i+1] only, so a signal padded
    with zeros (a longer batch row) gives the same samples, bitwise."""
    x = _x(90000, 4)
    short = tf.sosfilt(SOS, torch.from_numpy(x), mode="blocked").numpy()
    long_ = tf.sosfilt(SOS, torch.from_numpy(np.r_[x, np.zeros(
        70000, np.float32)]), mode="blocked").numpy()
    np.testing.assert_array_equal(long_[:len(x)], short)


def test_sos_impulse_response_and_trim_match_jax():
    """The impulse response and its trim are host float64 in both
    packages: equal, bitwise, with the same length (7168 taps here)."""
    for ntaps in (4096, 16384):
        np.testing.assert_array_equal(tf._sos_impulse_response(SOS, ntaps),
                                      jf._sos_impulse_response(SOS, ntaps))
        got = tf._sos_ir_trimmed(SOS, ntaps)
        np.testing.assert_array_equal(got, jf._sos_ir_trimmed(SOS, ntaps))
    assert tf.blocked_section_len(len(got)) == 32768


def test_lfilter_low_order_matches_scipy_and_jax():
    """The parallel-prefix lfilter on the JAX package's own case,
    butter(2, 0.2) (tests/test_filters.py:36): within 1e-4 of scipy's
    float64 recursion, the JAX package's bound, and within 2e-6 of the
    JAX associative scan (float32 products of the companion matrices
    composed in another order; measured 3.6e-7)."""
    b, a = sp.butter(2, 0.2)
    x = np.random.RandomState(1).randn(4096).astype(np.float32)
    got = tf.lfilter(tuple(b), tuple(a), torch.from_numpy(x)).numpy()
    ref = sp.lfilter(b, a, x.astype(np.float64))
    jx = np.asarray(jf.lfilter(tuple(b), tuple(a), jnp.asarray(x)))
    assert np.abs(got - ref).max() < 1e-4
    assert np.abs(got - jx).max() < 2e-6


@pytest.mark.parametrize("order,wn", [(1, 0.05), (3, 0.3), (4, 0.4)])
def test_lfilter_other_orders_match_scipy(order, wn):
    """Orders 1, 3 and 4 (poles away from the unit circle) against
    scipy's float64 recursion, within 1e-4 as above."""
    b, a = sp.butter(order, wn)
    x = np.random.RandomState(order).randn(4096).astype(np.float32)
    got = tf.lfilter(tuple(b), tuple(a), torch.from_numpy(x)).numpy()
    assert np.abs(got - sp.lfilter(b, a, x.astype(np.float64))).max() < 1e-4


def test_lfilter_fir_and_rows():
    """An FIR (a = [1]) is a plain convolution, and rows are filtered
    apart: against scipy within 1e-5 (float32 sums)."""
    b = (0.25, 0.5, 0.25)
    x = np.random.RandomState(2).randn(3, 500).astype(np.float32)
    got = tf.lfilter(b, (1.0,), torch.from_numpy(x)).numpy()
    ref = sp.lfilter(b, (1.0,), x.astype(np.float64), axis=-1)
    assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("fs", [16000, 48000])
def test_filter_designs_match_jax(fs):
    """The host scipy designs are the JAX package's, value for value."""
    assert tf.ellip_highpass_coeffs(4, 0.5, 80.0, 60.0, fs) == \
        jf.ellip_highpass_coeffs(4, 0.5, 80.0, 60.0, fs)
    assert tf.butter_highpass_coeffs(4, 40.0, fs) == \
        jf.butter_highpass_coeffs(4, 40.0, fs)
    assert tf.butter_highpass_sos(4, 40.0, fs) == \
        jf.butter_highpass_sos(4, 40.0, fs)


def _utts(n, F, seed):
    """Synthetic compressed features with ~30% unvoiced frames (the
    inputs of tests/test_torch_keys.py), 20/10 dims."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        m = F - 5 * b
        mag = rng.standard_normal((m, 20)).astype(np.float32) * 0.3 - 3.0
        real = np.clip(rng.standard_normal((m, 10)) * 0.3, -1, 1)
        imag = np.clip(rng.standard_normal((m, 10)) * 0.3, -1, 1)
        lf0 = np.log(rng.uniform(90, 250, m))
        lf0[rng.random(m) < 0.3] = -1.0e10
        out.append((mag, real, imag, lf0))
    return out


def test_blocked_hpf_batch_matches_jax(monkeypatch):
    """MAGPHASE_HPF_MODE=blocked in both packages, the same keys: the same
    audio within 1e-5 of the peak, the bound of
    tests/test_torch_keys.py::_assert_audio_close (float32 FFT round-off
    of two FFT libraries), which the blocked convolution's own FFTs add
    to."""
    monkeypatch.setenv("MAGPHASE_HPF_MODE", "blocked")
    utts = _utts(3, 160, 0)
    key = prng_key(3)
    ref = jbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=512, key=jax.numpy.asarray(key))
    got = tbatch.synthesis_from_compressed_batch(utts, FS, fft_len=512,
                                                 key=key, device="cpu")
    peak = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= 1e-5 * peak


def test_blocked_hpf_is_not_the_spectral_one(monkeypatch):
    """The two modes filter differently (per frame against per signal):
    the blocked audio is not the spectral audio, and both differ from no
    high-pass."""
    utts = _utts(2, 120, 1)
    kw = dict(fft_len=512, keys=split(prng_key(1), 2), device="cpu")
    spectral = tbatch.synthesis_from_compressed_batch(utts, FS, **kw)
    monkeypatch.setenv("MAGPHASE_HPF_MODE", "blocked")
    blocked = tbatch.synthesis_from_compressed_batch(utts, FS, **kw)
    none = tbatch.synthesis_from_compressed_batch(utts, FS, b_out_hpf=False,
                                                  **kw)
    for s, b, n in zip(spectral, blocked, none):
        assert not np.array_equal(s, b) and not np.array_equal(b, n)


def _compositions(device):
    """One utterance's blocked-mode audio in three batches: alone, first
    of four and last of five (other utterances longer and shorter), with
    det_fft_syn and its own key: (alone, in four, in five)."""
    utts = _utts(5, 200, 2)
    keys = split(prng_key(6), 5)
    kw = dict(fft_len=512, det_fft_syn=True, device=device)
    alone = tbatch.synthesis_from_compressed_batch(
        [utts[2]], FS, keys=keys[2:3], **kw)[0]
    four = tbatch.synthesis_from_compressed_batch(
        [utts[2], utts[0], utts[4], utts[1]], FS,
        keys=keys[[2, 0, 4, 1]], **kw)[0]
    five = tbatch.synthesis_from_compressed_batch(
        [utts[4], utts[0], utts[3], utts[1], utts[2]], FS,
        keys=keys[[4, 0, 3, 1, 2]], **kw)[-1]
    return alone, four, five


def test_blocked_hpf_independent_of_batch_composition(monkeypatch):
    """The contract of MAGPHASE_HPF_MODE=blocked (JAX parallel/batch.py:
    228-232): with det_fft_syn and per-utterance keys an utterance's audio
    does not depend on the batch it is in, byte for byte."""
    monkeypatch.setenv("MAGPHASE_HPF_MODE", "blocked")
    alone, four, five = _compositions("cpu")
    np.testing.assert_array_equal(four, alone)
    np.testing.assert_array_equal(five, alone)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_blocked_hpf_independent_of_batch_composition(cuda_device,
                                                           monkeypatch):
    """The same byte-identity on the card, where the blocked sections'
    FFTs run in calls of a fixed row count (core/spectral.py:rows_fft)."""
    monkeypatch.setenv("MAGPHASE_HPF_MODE", "blocked")
    alone, four, five = _compositions(cuda_device)
    np.testing.assert_array_equal(four, alone)
    np.testing.assert_array_equal(five, alone)
