"""The port's pitch-synchronous Griffin-Lim (vocoder/griffin_lim.py)
against the JAX package: the first iterations tightly, and the full run
by its convergence, which is stable to round-off where the phase of
near-zero bins is not.
"""
import jax
import numpy as np
import pytest

from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu.vocoder.griffin_lim import griffin_lim as jgriffin_lim
from magphase_tpu_torch.utils.keys import prng_key
from magphase_tpu_torch.vocoder import lossless as tl
from magphase_tpu_torch.vocoder.griffin_lim import griffin_lim

FS = 16000
INITS = ["random", "linear", "min_phase", "array"]


@pytest.fixture(scope="module")
def target():
    """The half magnitude (frames, 257) of 0.6 s of 16 kHz make_stimulus
    speech at its true epochs, fft_len 512, with the frame shifts."""
    sig, gci = make_stimulus(FS, [(0.6, 120, 170)], seed=2)[:2]
    pm = np.round(gci * FS).astype(np.int64)[1:-1]
    mag = tl.analysis_with_del_comp_from_pm(sig, FS, pm, np.ones(len(pm)),
                                            fft_len=512, device="cpu")[0]
    return mag, np.diff(np.r_[0, pm])


def _init(init, mag):
    if init != "array":
        return init
    return np.random.RandomState(7).uniform(-np.pi, np.pi, mag.shape)


def _run(init, mag, shifts, niters):
    key = prng_key(3)
    got = griffin_lim(mag, shifts, phase_init=_init(init, mag),
                      niters=niters, key=key, device="cpu")
    ref = jgriffin_lim(mag, shifts, phase_init=_init(init, mag),
                       niters=niters, key=jax.numpy.asarray(key))
    return got, ref


@pytest.mark.parametrize("niters", [1, 2])
@pytest.mark.parametrize("init", INITS)
def test_first_iterations_match_jax(target, init, niters):
    """niters=1 is one synthesis (complex ifft, K2) from the initial
    phase; niters=2 adds one re-analysis (K1, roll, angle(fft)) and a
    second synthesis.  The random phase is the same draw (keys.uniform is
    jax.random.uniform bit for bit).  Waveforms within 1e-5 of the peak
    (float32 FFT round-off of two FFT libraries; measured 2.6e-6 of the
    peak, the most for min_phase); the half phase, where the magnitude is
    above 1e-3 of its peak, within 2e-3 rad (the angle of a low bin
    inherits the FFT round-off relative to its magnitude)."""
    mag, shifts = target
    (v, ph), (rv, rph) = _run(init, mag, shifts, niters)
    assert v.shape == rv.shape and ph.shape == mag.shape == rph.shape
    assert np.abs(v - rv).max() <= 1e-5 * np.abs(rv).max()
    big = mag > 1e-3 * mag.max()
    d = np.angle(np.exp(1j * (ph - rph)))[big]
    assert np.abs(d).max() <= 2e-3


def _spectral_convergence(mag, shifts, v_sig):
    """||mag(sig) - target|| / ||target||, the re-analysed magnitude taken
    at the same marks."""
    pm = np.cumsum(shifts)
    got = tl.analysis_with_del_comp_from_pm(v_sig, FS, pm, np.ones(len(pm)),
                                            fft_len=512, device="cpu")[0]
    n = min(len(got), len(mag))
    return float(np.linalg.norm(got[:n] - mag[:n]) / np.linalg.norm(mag[:n]))


@pytest.mark.parametrize("init", INITS)
def test_thirty_iterations_converge_as_jax(target, init):
    """The default 30 iterations.  The phase of near-zero bins diverges
    chaotically between FFT libraries, so the waveforms are not compared;
    the spectral convergence of the output against the target magnitude
    is: within 1e-3 of the JAX package's, relative (measured 8.7e-6, for
    min_phase; 0.11-0.14 against 0.14-0.57 after one iteration), and no
    worse than after one iteration in either package."""
    mag, shifts = target
    (v, _), (rv, _) = _run(init, mag, shifts, 30)
    (v1, _), (rv1, _) = _run(init, mag, shifts, 1)
    sc = _spectral_convergence(mag, shifts, v)
    sc_ref = _spectral_convergence(mag, shifts, rv)
    assert np.all(np.isfinite(v)) and v.shape == rv.shape
    assert abs(sc - sc_ref) <= 1e-3 * sc_ref
    assert sc <= _spectral_convergence(mag, shifts, v1) * 1.001
    assert sc_ref <= _spectral_convergence(mag, shifts, rv1) * 1.001


def test_bad_inits_raise(target):
    mag, shifts = target
    with pytest.raises(ValueError):
        griffin_lim(mag, shifts, phase_init="bogus", niters=1, device="cpu")
    with pytest.raises(ValueError):
        griffin_lim(mag, shifts, phase_init=np.zeros((3, 3)), niters=1,
                    device="cpu")
