"""The single-utterance building blocks of the port against the JAX package:
the numpy window helpers, the output high-pass coefficients, the single
framing forms (batches of one through kernels K1/K2), interp_linear_axis0,
the frame-rate conversion of vocoder/framerate.py and the filter-bank mel
warp of core/fbank.py.  All on the CPU at small sizes; inputs from seeded
numpy.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from magphase_tpu.core import fbank as jfbank
from magphase_tpu.core import filters as jfilters
from magphase_tpu.core import framing as jframing
from magphase_tpu.core import interp as jinterp
from magphase_tpu.core import windows as jwindows
from magphase_tpu.vocoder import framerate as jfr
from magphase_tpu_torch.core import fbank as tfbank
from magphase_tpu_torch.core import filters as tfilters
from magphase_tpu_torch.core import framing as tframing
from magphase_tpu_torch.core import interp as tinterp
from magphase_tpu_torch.core import windows as twindows
from magphase_tpu_torch.vocoder import framerate as tfr

FS = 48000
CPU = dict(device="cpu")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# host numpy helpers: bit for bit

@pytest.mark.parametrize("case", [
    ("hanning_np", (17,)), ("hanning_np", (1024,)),
    ("gen_non_symmetric_win_np", (30, 45)),
    ("gen_non_symmetric_win_np", (0, 12)),
    ("gen_non_symmetric_win_np", (200, 7, "hanning", True)),
    ("gen_non_symmetric_win_np", (9, 9, "bartlett", False)),
    ("voi_noise_window_np", (321,))], ids=str)
def test_window_helpers_bitwise(case):
    name, args = case
    args = tuple(getattr(np, a) if isinstance(a, str) else a for a in args)
    np.testing.assert_array_equal(getattr(twindows, name)(*args),
                                  getattr(jwindows, name)(*args))


@pytest.mark.parametrize("fs", [16000, 48000])
def test_butter_highpass_coeffs_equal(fs):
    """The output high-pass of single-utterance synthesis: the same (b, a)
    (scipy float64 on both sides)."""
    assert (tfilters.butter_highpass_coeffs(4, 40.0, fs)
            == jfilters.butter_highpass_coeffs(4, 40.0, fs))


# ---------------------------------------------------------------------------
# single framing forms

def _marks(rng, n_sig, F, nfrms):
    pm = np.zeros(F, np.int32)
    pm[:nfrms] = np.sort(rng.choice(np.arange(50, n_sig - 50), nfrms,
                                    replace=False))
    return pm


def test_frame_geometry_matches_jax():
    rng = np.random.default_rng(0)
    pm = _marks(rng, 6000, 32, 25)
    ref = jframing.frame_geometry(jnp.asarray(pm), 25, 6000)
    got = tframing.frame_geometry(pm, 25, 6000, **CPU)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), np.asarray(r))


@pytest.mark.parametrize("voiced", [False, True], ids=["hanning", "select"])
def test_pitch_sync_frames_matches_jax(voiced):
    """Windowed delay-compensated frames of one utterance (kernel K1's
    plain version) within 1e-6 absolute of the JAX gather on unit-scale
    samples (measured 2.4e-7); L, R and the valid mask equal."""
    rng = np.random.default_rng(1)
    n_sig, F, nfrms, fft_len = 6000, 32, 25, 1024
    sig = rng.standard_normal(n_sig).astype(np.float32)
    pm = _marks(rng, n_sig, F, nfrms)
    kw = {}
    if voiced:
        kw = dict(win_family=jwindows.VOI_NOISE,
                  voiced=(rng.random(F) < 0.5).astype(np.float32),
                  win_family_unvoiced=jwindows.HANNING)
    ref = jframing.pitch_sync_frames(
        jnp.asarray(sig), jnp.asarray(pm), nfrms, n_sig, fft_len,
        **{k: (jnp.asarray(v) if k == "voiced" else v)
           for k, v in kw.items()})
    got = tframing.pitch_sync_frames(sig, pm, nfrms, n_sig, fft_len, **kw,
                                     **CPU)
    np.testing.assert_allclose(_np(got[0]), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(_np(g), np.asarray(r))


def test_ola_centered_matches_jax_scatter():
    """Overlap-add of one utterance (kernel K2's plain version) against the
    JAX package's XLA scatter: within 1e-6 absolute on unit-scale frames
    (measured 0), frames starting before the buffer included."""
    rng = np.random.default_rng(2)
    F, nfrms, N, out_len = 32, 27, 512, 5000
    frames = rng.standard_normal((F, N)).astype(np.float32)
    pm = _marks(rng, out_len, F, nfrms)
    pm[0] = 10                          # its frame starts at -246
    ref = jframing.ola_centered(jnp.asarray(frames), jnp.asarray(pm), nfrms,
                                out_len)
    got = tframing.ola_centered(frames, pm, nfrms, out_len, **CPU)
    assert got.shape == (out_len,)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# interpolation

@pytest.mark.parametrize("cols", [None, 5])
def test_interp_linear_axis0_matches_jax(cols):
    """Within 1e-6 relative (float32 on both sides, data in [1, 2];
    measured 0), with queries below, inside and above the grid and
    repeated grid points."""
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 100, 40))
    x[10] = x[11]
    x[25:28] = x[25]
    shape = (40,) if cols is None else (40, cols)
    m = rng.uniform(1.0, 2.0, shape)
    q = np.r_[-5.0, x[[0, 10, 25, 39]], rng.uniform(0, 100, 50), 120.0]
    ref = jinterp.interp_linear_axis0(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(m, jnp.float32),
                                      jnp.asarray(q, jnp.float32))
    got = tinterp.interp_linear_axis0(x, m, q, **CPU)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# frame-rate conversion

def _const_shifts(rng, n):
    """A 5 ms-grid shift track: fs/f0 where voiced, the 200 Hz unvoiced
    shift elsewhere."""
    f0 = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(80.0, 300.0, n))
    return tfr.f0_to_shift_np(f0, FS)


def test_const_shift_walk_bitwise():
    """get_shifts_and_frm_locs_from_const_shifts: host float64 on both
    sides, bit for bit."""
    v = _const_shifts(np.random.default_rng(4), 120)
    for g, r in zip(tfr.get_shifts_and_frm_locs_from_const_shifts(v, 5.0, FS),
                    jfr.get_shifts_and_frm_locs_from_const_shifts(v, 5.0,
                                                                  FS)):
        np.testing.assert_array_equal(g, r)


def test_shift_to_f0_np_bitwise():
    rng = np.random.default_rng(5)
    shift = rng.integers(100, 600, 80).astype(np.float64)
    voi = (rng.random(80) < 0.6).astype(np.float64)
    for out in ("f0", "lf0"):
        np.testing.assert_array_equal(tfr.shift_to_f0_np(shift, voi, FS, out),
                                      jfr.shift_to_f0_np(shift, voi, FS, out))


@pytest.mark.parametrize("first_pm", [0, 173], ids=["pm0", "anchored"])
@pytest.mark.parametrize("cols", [None, 7])
def test_variable_to_const_rate_matches_jax(first_pm, cols):
    """interp_from_variable_to_const_frm_rate from float64 host arrays
    (float32 on the device, as the JAX package computes with 64-bit types
    off): within 1e-6 relative, data in [1, 2] (measured 0)."""
    rng = np.random.default_rng(6)
    pm = first_pm + np.cumsum(rng.integers(150, 500, 60)).astype(np.float64)
    pm -= pm[0] - first_pm
    m = rng.uniform(1.0, 2.0, (60,) if cols is None else (60, cols))
    ref = jfr.interp_from_variable_to_const_frm_rate(m, pm, 5.0, FS)
    got = tfr.interp_from_variable_to_const_frm_rate(m, pm, 5.0, FS, **CPU)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6, atol=0)


@pytest.mark.parametrize("cols", [None, 7])
def test_const_to_variable_rate_matches_jax(cols):
    """interp_from_const_to_variable_rate at the frame locations of the
    backward walk: within 1e-6 relative, data in [1, 2] (measured 0)."""
    rng = np.random.default_rng(7)
    v = _const_shifts(rng, 90)
    _, locs = jfr.get_shifts_and_frm_locs_from_const_shifts(v, 5.0, FS)
    m = rng.uniform(1.0, 2.0, (90,) if cols is None else (90, cols))
    ref = jfr.interp_from_const_to_variable_rate(m, locs, 5.0, FS)
    got = tfr.interp_from_const_to_variable_rate(m, locs, 5.0, FS, **CPU)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6, atol=0)


def test_to_constant_rate_matches_jax():
    rng = np.random.default_rng(8)
    shift = rng.integers(150, 500, 50)
    m = rng.uniform(1.0, 2.0, (50, 4))
    ref = jfr.to_constant_rate(m, 5.0, shift, FS)
    got = tfr.to_constant_rate(m, 5.0, shift, FS, **CPU)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6, atol=0)


def _padded_utterance(rng, F, n, tie):
    pm = np.zeros(F, np.int32)
    pm[:n] = np.cumsum(rng.integers(120, 480, n))
    f0 = np.zeros(F, np.float32)
    f0[:n] = np.where(rng.random(n) < 0.35, 0.0,
                      rng.uniform(80.0, 300.0, n))
    if tie:
        # two voiced frames on one mark: the stable sort keeps their order
        f0[10:13] = [120.0, 150.0, 180.0]
        pm[11] = pm[10]
    feats = tuple(rng.uniform(-1.0, 1.0, (F, d)).astype(np.float32)
                  for d in (33, 33, 33))
    return feats, f0, pm


@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "tied"])
def test_const_rate_resample_core_matches_jax(tie):
    """One padded utterance to the 5 ms grid: streams within 1e-5, n_const
    equal, f0 equal in voicing and within 1e-6 relative (both measured
    0)."""
    rng = np.random.default_rng(9)
    F, n, fc_max = 128, 100, 256
    feats, f0, pm = _padded_utterance(rng, F, n, tie)
    kw = dict(const_rate_smpls=240.0, fc_max=fc_max)
    (r_outs, r_f0, r_n) = jfr.const_rate_resample_core(
        tuple(jnp.asarray(m) for m in feats), jnp.asarray(f0),
        jnp.asarray(pm), jnp.int32(n), **kw)
    (g_outs, g_f0, g_n) = tfr.const_rate_resample_core(feats, f0, pm, n, **kw,
                                                       **CPU)
    assert int(g_n) == int(r_n)
    for g, r in zip(g_outs, r_outs):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=0, atol=1e-5)
    g_f0, r_f0 = _np(g_f0), np.asarray(r_f0)
    np.testing.assert_array_equal(g_f0 > 0, r_f0 > 0)
    np.testing.assert_allclose(g_f0, r_f0, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# filter-bank mel warp

NBINS, NBANDS = 2049, 60        # fft_len 4096, mag_dim 60
CURVE = (0.77, 2049, 427, 45)   # (alpha, bins, bins below 5 kHz, bands)


@pytest.mark.parametrize("case", [
    ("_fbank_matrix_np", (0.77, NBINS, NBANDS)),
    ("_unwarp_interp_matrix_np", (0.77, NBINS, NBANDS)),
    ("_unwarp_interp_matrix_np", (0.58, 513, 40, "linear")),
    ("_unwarp_curve_matrix_np", CURVE),
    ("_fbank_curve_matrix_np", CURVE)], ids=str)
def test_fbank_matrices_bitwise(case):
    name, args = case
    np.testing.assert_array_equal(getattr(tfbank, name)(*args),
                                  getattr(jfbank, name)(*args))


def _mag(rng, n, h):
    return np.exp(rng.standard_normal((n, h))).astype(np.float32)


@pytest.mark.parametrize("fn", [
    "apply_fbank", "sp_mel_warp_fbank", "sp_mel_warp_fbank_2d",
    "unwarp_from_fbank", "sp_mel_unwarp_fbank", "unwarp_from_fbank_curve",
    "apply_fbank_curve"])
def test_fbank_functions_match_jax(fn):
    """Each public function of core/fbank.py within 1e-5 of the output's
    peak (float32 matmuls on both sides, summed in another order; the log
    filter-bank outputs cross zero, where an elementwise relative bound
    means nothing; measured 2.0e-7 of the peak)."""
    rng = np.random.default_rng(10)
    mag = _mag(rng, 24, NBINS)
    log_mel = rng.uniform(-3.0, 1.0, (24, NBANDS)).astype(np.float32)
    args = {"apply_fbank": (np.log(mag), 0.77, NBANDS),
            "sp_mel_warp_fbank": (mag, NBANDS, 0.77),
            "sp_mel_warp_fbank_2d": (mag, NBANDS, 0.77),
            "unwarp_from_fbank": (log_mel, 0.77, NBINS),
            "sp_mel_unwarp_fbank": (log_mel, NBINS, 0.77),
            "unwarp_from_fbank_curve": (log_mel[:, :45],) + CURVE[:3],
            "apply_fbank_curve": (np.log(mag),) + CURVE}[fn]
    ref = np.asarray(getattr(jfbank, fn)(jnp.asarray(args[0]), *args[1:]))
    got = _np(getattr(tfbank, fn)(args[0], *args[1:], **CPU))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_fbank_matrix_uploaded_once_per_device():
    """A warp or unwarp builds its (bins, bands) matrix on the tensor's
    device once and reuses it: a second call of the same configuration
    adds no entry to the cache and returns the same values."""
    mag = _mag(np.random.default_rng(11), 8, NBINS)
    first = _np(tfbank.sp_mel_warp_fbank(mag, NBANDS, 0.77, **CPU))
    size = tfbank._matrix.cache_info().currsize
    again = _np(tfbank.sp_mel_warp_fbank(mag, NBANDS, 0.77, **CPU))
    assert tfbank._matrix.cache_info().currsize == size
    np.testing.assert_array_equal(again, first)
