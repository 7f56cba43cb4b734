"""The port's pitch tracker and device epoch placement against the JAX
package: the constants carried across, each tracker stage fed the JAX
stage's own input, the batched track + walk on seeded stimuli, and the
tracker's quality on stimuli with known epochs.
"""
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from magphase_tpu.epochs import placement_device as jpd
from magphase_tpu.epochs import tracker as jt
from magphase_tpu.parallel import analysis_batch as jab
from magphase_tpu.utils.tracker_eval import make_stimulus, tracker_metrics
from magphase_tpu_torch.epochs import extract_epochs
from magphase_tpu_torch.epochs import placement_device as tpd
from magphase_tpu_torch.epochs import tracker as tt
from magphase_tpu_torch.parallel import analysis_batch as tab

FS = 48000

# the clean cases of tests/test_tracker_groundtruth.py
SYNTH_CASES = {
    "steady120": [(0.3, 120, 120)],
    "rise90_180": [(0.4, 90, 180)],
    "fall300_150": [(0.4, 300, 150)],
    "high350": [(0.3, 350, 350)],
    "low60": [(0.4, 60, 60)],
    "low_male_55_85": [(0.5, 55, 85)],
    "mixed": [(0.2, None, None), (0.3, 140, 200), (0.15, None, None),
              (0.3, 220, 110), (0.1, None, None)],
}


def _stimuli(fs=FS):
    """steady120, mixed and one noise signal, all from fixed seeds."""
    rng = np.random.default_rng(3)
    return [make_stimulus(fs, SYNTH_CASES["steady120"], seed=1)[0],
            make_stimulus(fs, SYNTH_CASES["mixed"], seed=1)[0],
            rng.uniform(-0.3, 0.3, int(0.6 * fs))]


@functools.lru_cache(maxsize=None)
def _jax_stages():
    """The JAX tracker's stage outputs on the padded stimulus batch, and
    the batch's geometry."""
    _, (sigs, n_sigs, n_frames), _, Tmax, m_max, _ = jab._host_signal_batch(
        _stimuli(), FS, None, fft_len=4096)
    sig = np.asarray(jab._sigs_f32(jnp.asarray(sigs)))
    fs_a = jt.analysis_rate(FS)[0]
    xa, y_snap = jax.vmap(functools.partial(jt._preprocess, fs=FS))(sig)
    nccf, valid = jax.vmap(functools.partial(
        jt._nccf, n_frames_max=Tmax, fs_a=fs_a))(xa, jnp.asarray(n_frames))
    vals, lags = jax.vmap(jt._candidates)(nccf)
    states = jax.vmap(functools.partial(jt._viterbi, fs_a=fs_a))(
        vals, lags, valid)
    out = dict(sig=sig, n_sigs=n_sigs, n_frames=n_frames, Tmax=Tmax,
               m_max=m_max, fs_a=fs_a)
    for k, v in dict(xa=xa, y_snap=y_snap, nccf=nccf, valid=valid,
                     vals=vals, lags=lags, states=states).items():
        out[k] = np.asarray(v)
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# constants carried across

def test_tracker_constants_and_fir_taps_are_the_jax_packages():
    """The vocoder has no learned weights; its tables are these constants
    and FIR taps, which must equal the JAX package's bit for bit."""
    for name in ("F0_MIN", "F0_MAX", "FRAME_STEP_S", "FS_ANALYSIS",
                 "CORR_WIN_S", "N_CAND", "UV_LOCAL", "VUV_COST", "TRANS_W",
                 "LAG_BIAS", "SNAP_HALF_RUN", "SNAP_HALF_ONSET",
                 "SNAP_ONSET_MARKS", "_OS_BLOCK"):
        assert getattr(tt, name) == getattr(jt, name), name
    for fs in (16000, 22050, 44100, 48000):
        assert tt.analysis_rate(fs) == jt.analysis_rate(fs)
        assert tpd._snap_win(fs) == jpd._snap_win(fs)
        assert tpd._walk_frame_step(fs) == jpd._walk_frame_step(fs)
        assert tpd.placement_m_max(163840, fs) == jpd.placement_m_max(
            163840, fs)
        fs_a = tt.analysis_rate(fs)[0]
        for fn, fc in ((tt._fir_highpass, 80.0), (tt._fir_lowpass, 800.0),
                       (tt._fir_lowpass, 0.45 * fs_a)):
            ref = getattr(jt, fn.__name__)(fc, fs)
            np.testing.assert_array_equal(fn(fc, fs), ref)


# ---------------------------------------------------------------------------
# each stage fed the JAX stage's own input

def test_preprocess_matches_jax():
    """xa and y_snap from the same padded rows.  Bound 1e-6 absolute on
    signals of peak ~0.5: float32 FFT round-off between pocketfft builds
    and the row mean summed in another order (measured 1.2e-7)."""
    j = _jax_stages()
    xa, y_snap = tt._preprocess(_t(j["sig"]), fs=FS)
    np.testing.assert_allclose(xa.numpy(), j["xa"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(y_snap.numpy(), j["y_snap"], rtol=0,
                               atol=1e-6)


def test_nccf_matches_jax():
    """NCCF in [-1, 1] on valid frames.  Bound 1e-5: the energy cumsum
    runs in another order than XLA's, and FFT round-off (measured
    1.7e-6); the validity mask is exact."""
    j = _jax_stages()
    nccf, valid = tt._nccf(_t(j["xa"]), _t(j["n_frames"]),
                           n_frames_max=j["Tmax"], fs_a=j["fs_a"])
    np.testing.assert_array_equal(valid.numpy(), j["valid"])
    v = j["valid"]
    np.testing.assert_allclose(nccf.numpy()[v], j["nccf"][v], rtol=0,
                               atol=1e-5)


def test_candidates_match_jax():
    """The selected values are entries of the same NCCF, so they are
    equal; the refined lags where a candidate is real (vals > -1.5) to
    1e-5 (a few float32 ops that XLA may contract; measured 0)."""
    j = _jax_stages()
    vals, lags = tt._candidates(_t(j["nccf"]))
    np.testing.assert_array_equal(vals.numpy(), j["vals"])
    real = j["vals"] > -1.5
    np.testing.assert_allclose(lags.numpy()[real], j["lags"][real], rtol=0,
                               atol=1e-5)


def test_candidate_ties_keep_the_lax_top_k_order():
    """Non-peaks all score -2.0: tied lags come out in increasing order, as
    lax.top_k gives them (torch.topk does not)."""
    row = np.asarray([-2, 1, -2, -2, 3, -2], np.float32)
    _, ref = jax.lax.top_k(jnp.asarray(row), 4)
    _, idx = torch.sort(_t(row), descending=True, stable=True)
    np.testing.assert_array_equal(idx[:4].numpy(), np.asarray(ref))


def test_viterbi_states_match_jax():
    """The best state path over all Tmax frames, padding included: equal."""
    j = _jax_stages()
    states = tt._viterbi(_t(j["vals"]), _t(j["lags"]), _t(j["valid"]),
                         fs_a=j["fs_a"])
    np.testing.assert_array_equal(states.numpy(), j["states"])


# ---------------------------------------------------------------------------
# the slice's phase 1 as a whole

def test_track_and_place_batch_matches_jax():
    """Marks, flags and n_marks of the port's batched track + walk equal
    the JAX package's on steady120, mixed and noise (and the silent batch
    dummies): identical, no round-off bound needed."""
    j = _jax_stages()
    kw = dict(fs=FS, n_frames_max=j["Tmax"], m_max=j["m_max"])
    args = (j["sig"], j["n_sigs"], j["n_frames"])
    ref = jax.jit(functools.partial(jpd.track_and_place_batch, **kw))(
        *(jnp.asarray(a) for a in args))
    got = tpd.track_and_place_batch(*(_t(a) for a in args), **kw)
    assert int(np.asarray(ref[2])[:3].min()) > 20
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_track_f0_batch_matches_jax():
    """Voicing equal to the JAX package's; f0 to 1e-6 relative (the
    refined lag inherits the NCCF's round-off; measured 1.3e-7); y_snap to
    1e-6 absolute as in test_preprocess_matches_jax."""
    sigs = _stimuli()[:2]
    got = tab.track_f0_batch(sigs, FS, device="cpu")
    ref = jab.track_f0_batch(sigs, FS)
    for (f0, voi, ys), (rf0, rvoi, rys) in zip(got, ref):
        np.testing.assert_array_equal(voi, rvoi)
        np.testing.assert_allclose(f0, rf0, rtol=1e-6, atol=0)
        np.testing.assert_allclose(ys, rys, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SYNTH_CASES))
def test_extract_epochs_on_known_epoch_stimuli(name):
    """The port's extract_epochs meets the clean gates of
    tests/test_tracker_groundtruth.py on the same stimuli."""
    sig, gci, ivals, f0_at = make_stimulus(FS, SYNTH_CASES[name], seed=1)
    pm, voi = extract_epochs(sig, FS, device="cpu")
    m = tracker_metrics(pm, voi, gci, ivals, f0_at, len(sig) / FS)
    assert m["gpe"] < 0.01, m
    assert m["voi_miss"] < 0.02, m
    assert m["voi_fa"] < 0.03, m
    assert m["gci_hit"] > 0.93, m
    assert m["gci_jitter"] < 1.0e-3, m


def test_extract_epochs_matches_jax():
    """The host walk over the port's track gives the JAX package's marks."""
    sig = _stimuli()[1]
    pm, voi = extract_epochs(sig, FS, device="cpu")
    rpm, rvoi = jt.extract_epochs(sig, FS)
    np.testing.assert_array_equal(pm, rpm)
    np.testing.assert_array_equal(voi, rvoi)


@pytest.mark.parametrize("mode", ["clip30", "cube", "bogus"])
def test_unported_whiten_modes_raise(mode, monkeypatch):
    """MAGPHASE_TRACKER_WHITEN: an unknown value ('bogus') raises
    ValueError; the JAX package's modes 'clipNN' and 'cube' run and give
    its marks and flags on the mixed stimulus, exactly (as
    test_extract_epochs_matches_jax for 'none')."""
    monkeypatch.setenv("MAGPHASE_TRACKER_WHITEN", mode)
    sig = _stimuli()[1]
    if mode == "bogus":
        with pytest.raises(ValueError):
            extract_epochs(sig, FS, device="cpu")
    else:
        pm, voi = extract_epochs(sig, FS, device="cpu")
        rpm, rvoi = jt.extract_epochs(sig, FS)
        np.testing.assert_array_equal(pm, rpm)
        np.testing.assert_array_equal(voi, rvoi)
    assert os.environ["MAGPHASE_TRACKER_WHITEN"] == mode


@pytest.mark.parametrize("mode", ["clip30", "clip12.5", "cube"])
def test_whitened_nccf_matches_jax(mode):
    """The NCCF of each whitening mode from the JAX stage's own input, at
    the bound and reason of test_nccf_matches_jax (1e-5), on every frame
    whose segment does not straddle a voicing boundary.  Across a
    boundary, clipping or cubing leaves the segment almost all zeros, the
    normalising energy sits near its 1e-12 floor and magnifies round-off
    without bound (measured up to 0.06, on 7 frames): those frames lie
    within one segment (27.5 ms) and one frame step of the boundaries of
    the mixed stimulus (stimulus 1), and only they may exceed it."""
    j = _jax_stages()
    ref = jax.vmap(functools.partial(
        jt._nccf, n_frames_max=j["Tmax"], fs_a=j["fs_a"], whiten=mode))(
        jnp.asarray(j["xa"]), jnp.asarray(j["n_frames"]))[0]
    nccf, valid = tt._nccf(_t(j["xa"]), _t(j["n_frames"]),
                           n_frames_max=j["Tmax"], fs_a=j["fs_a"],
                           whiten=mode)
    err = np.abs(nccf.numpy() - np.asarray(ref)).max(axis=-1)
    t0 = np.arange(err.shape[1]) * jt.FRAME_STEP_S
    bounds = np.cumsum([d for d, *_ in SYNTH_CASES["mixed"]])
    near = np.zeros(err.shape, bool)
    near[1] = np.any((bounds[None, :] >= t0[:, None] - jt.FRAME_STEP_S)
                     & (bounds[None, :] <= t0[:, None] + jt.CORR_WIN_S
                        + 1.0 / jt.F0_MIN + jt.FRAME_STEP_S), axis=1)
    far = valid.numpy() & ~near
    assert far.sum() > 300
    assert err[far].max() <= 1e-5


@pytest.mark.parametrize("mode", ["clip", "clipx", "Cube", "none "])
def test_bad_whiten_values_raise(mode, monkeypatch):
    """Values that name no mode raise before any work."""
    monkeypatch.setenv("MAGPHASE_TRACKER_WHITEN", mode)
    with pytest.raises(ValueError):
        tt.nccf_whiten_mode()


def test_track_and_place_one_matches_jax():
    """One utterance through the device tracker and walk (K4 as a batch of
    one) against the JAX package's per-utterance form (its XLA walk):
    marks, flags and the mark count equal."""
    j = _jax_stages()
    kw = dict(fs=FS, n_frames_max=j["Tmax"], m_max=j["m_max"])
    b = 1
    args = (j["sig"][b], j["n_sigs"][b], j["n_frames"][b])
    ref = jax.jit(functools.partial(jpd.track_and_place_one, **kw))(
        *(jnp.asarray(a) for a in args))
    got = tpd.track_and_place_one(_t(args[0]), int(args[1]), int(args[2]),
                                  **kw)
    assert int(ref[2]) > 20
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
