"""Wav-in compressed analysis of the port against the JAX package:
analysis_compressed_batch in both branches (tracked and given epochs), in
float32 and float16 output, the phase-2 layer alone, the budget split,
the capacity fallback, the mel-compression pieces, and the guards on the
options the port does not take.
"""
import importlib.util
import inspect
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import signal as sp_signal

from magphase_tpu.core import filters as jfilters
from magphase_tpu.core import melcep as jmelcep
from magphase_tpu.core import spectral as jspectral
from magphase_tpu.epochs import tracker as jt
from magphase_tpu.parallel import analysis_batch as jab
from magphase_tpu.utils import padding as jpadding
from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu.vocoder import compressed as jcompressed
from magphase_tpu.vocoder import lossless as jlossless
from magphase_tpu_torch.core import filters as tfilters
from magphase_tpu_torch.core import melcep as tmelcep
from magphase_tpu_torch.core import spectral as tspectral
from magphase_tpu_torch.epochs import extract_epochs
from magphase_tpu_torch.epochs import tracker as tt
from magphase_tpu_torch.parallel import analysis_batch as tab
from magphase_tpu_torch.parallel import batch as tbatch
from magphase_tpu_torch.parallel import copy_synthesis as tcs
from magphase_tpu_torch.utils import padding as tpadding
from magphase_tpu_torch.vocoder import compressed as tcompressed
from magphase_tpu_torch.vocoder import lossless as tlossless

FS = 48000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXED = [(0.2, None, None), (0.3, 140, 200), (0.15, None, None),
         (0.3, 220, 110), (0.1, None, None)]

# port vs the JAX entry, whose compressed analysis takes the default
# 'direct_high' matmul DFT (relative error ~1e-5 of the spectrum,
# analysis_batch.py:298-306): through the log and the mcep matmuls that
# is <= 5e-5 absolute on the mel streams here (measured); bound 5e-4
TOL_VS_JAX_ENTRY = 5e-4


def _signals():
    return [make_stimulus(FS, [(0.3, 120, 120)], seed=1)[0],
            make_stimulus(FS, MIXED, seed=1)[0],
            make_stimulus(FS, [(0.5, 90, 180)], seed=2)[0]]


def _assert_close(got, ref, atol, lf0_rtol=1e-6):
    """Streams within ``atol``, lf0 to ``lf0_rtol``, shift equal."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for i, (a, b) in enumerate(zip(g, r)):
            assert a.shape == b.shape and a.dtype == b.dtype, i
        for i in range(3):
            np.testing.assert_allclose(g[i], r[i], rtol=0, atol=atol)
        np.testing.assert_allclose(g[3], r[3], rtol=lf0_rtol, atol=0)
        np.testing.assert_array_equal(g[4], r[4])


def test_analysis_compressed_batch_matches_jax_float32():
    """The tracked branch end to end at the full width (48 kHz, fft_len
    4096, 60/45): same frame counts and shifts, streams within
    TOL_VS_JAX_ENTRY, lf0 to 1e-6 relative."""
    sigs = _signals()
    ref = jab.analysis_compressed_batch(sigs, FS, feat_dtype=np.float32)
    got = tab.analysis_compressed_batch(sigs, FS, feat_dtype=np.float32,
                                        device="cpu")
    assert [g[0].shape for g in got] == [(len(r[4]), 60) for r in ref]
    assert all(g[1].shape[1] == 45 for g in got)
    _assert_close(got, ref, TOL_VS_JAX_ENTRY)


def test_analysis_compressed_batch_float16_matches_jax():
    """The default float16 output: the mel streams are float16 values.  The
    float32 values before the rounding differ by up to TOL_VS_JAX_ENTRY,
    so the float16 values differ by at most that plus one float16 step of
    the value, on at most 2% of the entries (measured 0.2-0.6%); lf0 and
    shift stay float32/int as in the JAX package."""
    sigs = _signals()[:2]
    ref = jab.analysis_compressed_batch(sigs, FS, fft_len=2048)
    got = tab.analysis_compressed_batch(sigs, FS, fft_len=2048, device="cpu")
    for g, r in zip(got, ref):
        for i in range(3):
            assert g[i].dtype == np.float64
            np.testing.assert_array_equal(g[i].astype(np.float16), g[i])
            step = np.spacing(np.abs(r[i]).astype(np.float16)).astype(
                np.float64)
            d = np.abs(g[i] - r[i])
            assert np.all(d <= TOL_VS_JAX_ENTRY + step), i
            assert np.mean(d > 0) <= 0.02, i
        np.testing.assert_allclose(g[3], r[3], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g[4], r[4])


def _witness_signal(seconds=3.0, seed=0):
    """One signal of chip_smoke.py's analysis witness: damped two-formant
    pulses at an 80-300 Hz contour, noise in the unvoiced runs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.make_witness_signals(np.random.default_rng(seed), 1,
                                   seconds)[0][0]


def test_phase2_layer_matches_jax_native_rfft():
    """Phase 2 alone, tighter, at the full width (fft_len 4096, 60/45): the
    JAX analysis_core_batch with rfft_mode='native' (passed explicitly)
    then _compress_streams, against the port's on the same signals and
    marks.  Bound 5e-4 absolute on the mel streams: float32 FFT and matmul
    round-off, largest on the phase coefficients of weak frames (measured
    8.0e-5, on the 3 s witness signal); lf0 to 1e-6 relative (measured
    1.1e-7), shift equal.  chip_smoke.py bounds the card against the CPU
    at ten times the measured values."""
    sigs = _signals()[:2] + [_witness_signal()]
    _, (s, ns, nf), _, Tmax, m_max, _ = jab._host_signal_batch(
        sigs, FS, None, fft_len=4096)
    s = np.asarray(jab._sigs_f32(jnp.asarray(s)))
    marks, flags, n_marks = (np.asarray(a) for a in jab._track_place_kernel(
        jnp.asarray(s), jnp.asarray(ns), jnp.asarray(nf), fs=FS,
        n_frames_max=Tmax, m_max=m_max))
    F = jpadding.bucket_frames(int(n_marks.max()))
    alpha = 0.77
    mag_dim_ph = tcompressed.get_num_full_mel_coeffs_from_num_phase_coeffs(
        5000.0, 45, alpha, FS)
    ckw = dict(mag_dim=60, phase_dim=45, mag_dim_ph=mag_dim_ph, alpha=alpha,
               alpha_phase=alpha)

    @jax.jit
    def ref_fn(s, pm, nm, ns, voi):
        mag, real, imag, f0, shift = jlossless.analysis_core_batch(
            s, pm, nm, ns, voi, fft_len=4096, fs=FS, rfft_mode="native")
        return jab._compress_streams(mag, real, imag, f0, **ckw) + (shift,)

    ref = [np.asarray(a) for a in ref_fn(
        s, marks[:, :F], n_marks, ns, flags[:, :F])]
    got = tab._analyze_compress_impl(
        *(torch.from_numpy(np.array(a)) for a in (s, marks, flags, n_marks,
                                                  ns)),
        fs=FS, fft_len=4096, F=F, **ckw)
    got = [g.numpy() for g in got]
    v = np.arange(F)[None, :] < n_marks[:, None]
    for i in range(3):
        np.testing.assert_allclose(got[i][v], ref[i][v], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got[3][v], ref[3][v], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[4][v], ref[4][v])


def test_given_epochs_branch_matches_jax():
    """analysis_compressed_batch(epochs=...): the JAX tracker's epochs fed
    to both packages; float32 streams (that branch ignores feat_dtype in
    both), bound as the tracked branch's."""
    sigs = _signals()[1:]
    eps = [jt.extract_epochs(s, FS) for s in sigs]
    ref = jab.analysis_compressed_batch(sigs, FS, fft_len=2048, epochs=eps)
    got = tab.analysis_compressed_batch(sigs, FS, fft_len=2048, epochs=eps,
                                        device="cpu")
    _assert_close(got, ref, TOL_VS_JAX_ENTRY)


def test_budget_split_matches_one_group(monkeypatch):
    """A request split into groups of one utterance under a small frame
    budget gives each utterance's features as the whole batch does: frame
    counts and shifts equal, streams to 1e-5.  What changes is the row
    count of the batched FFTs and matmuls, and the padded length the row
    mean is taken over (a near-constant offset of the snap signal, which
    moves no trough here)."""
    sigs = _signals()
    kw = dict(fft_len=2048, feat_dtype=np.float32, device="cpu")
    whole = tab.analysis_compressed_batch(sigs, FS, **kw)
    S, m_max, _ = tab._budget_geometry(sigs, FS, 2048)
    monkeypatch.setattr(tab, "MAX_FRAME_ELEMS", m_max * 2048)
    assert tab._split_for_budget(sigs, FS, 2048) == [[s] for s in sigs]
    split = tab.analysis_compressed_batch(sigs, FS, **kw)
    _assert_close(split, whole, 1e-5)


def test_capacity_fallback_matches_jax(monkeypatch):
    """A walk capacity below the mark count redoes the utterance with the
    host walk and the given-epochs branch, in both packages alike; the
    port counts it in analysis_batch.capacity_fallbacks."""
    sigs = _signals()[1:2]
    monkeypatch.setattr(jab, "placement_m_max", lambda *a: 128)
    monkeypatch.setattr(tab, "placement_m_max", lambda *a: 128)
    ref = jab.analysis_compressed_batch(sigs, FS, fft_len=2048,
                                        feat_dtype=np.float32)
    before = tab.capacity_fallbacks
    got = tab.analysis_compressed_batch(sigs, FS, fft_len=2048,
                                        feat_dtype=np.float32, device="cpu")
    assert tab.capacity_fallbacks == before + 1
    assert len(got[0][4]) > 128
    _assert_close(got, ref, TOL_VS_JAX_ENTRY)


# ---------------------------------------------------------------------------
# mel compression pieces

def test_mcep_matrix_and_buckets_are_the_jax_packages():
    """Constant tables carried across bit for bit: the mcep matrix at the
    analysis widths, the frame bucket grid."""
    for f2, fft_len, n, alpha in ((2048, 4096, 60, 0.77),
                                  (2048, 4096, 113, 0.77),
                                  (1024, 2048, 60, 0.58)):
        np.testing.assert_array_equal(
            tmelcep.mcep_matrix_np(f2, fft_len, n, alpha),
            jmelcep.mcep_matrix_np(f2, fft_len, n, alpha))
    for n in (1, 127, 128, 129, 700, 5000, 10 ** 6):
        assert tpadding.bucket_frames(n) == jpadding.bucket_frames(n)


@pytest.mark.parametrize("in_type", [1, 2, 3])
def test_sp_mel_warp_matches_jax(in_type):
    """The forward mel warp for the three SPTK input types (dB, log, abs):
    5e-5 of the output scale (float32 matmul round-off)."""
    rng = np.random.default_rng(in_type)
    sp = rng.uniform(0.1, 2.0, (16, 1025)).astype(np.float32)
    if in_type == 1:
        sp = 20.0 * np.log10(sp)
    elif in_type == 2:
        sp = np.log(sp)
    got = tmelcep.sp_mel_warp(torch.from_numpy(sp), 60, alpha=0.77,
                              in_type=in_type).numpy()
    ref = np.asarray(jmelcep.sp_mel_warp(jnp.asarray(sp), 60, alpha=0.77,
                                         in_type=in_type))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=5e-5 * np.abs(ref).max())


def test_medfilt3_and_f0_to_lf0_match():
    """medfilt3 equals scipy's medfilt (kernel 3, zero padding) and the
    JAX package's, bitwise; f0_to_lf0 to float32 log round-off (<= 1 ulp
    between libms)."""
    rng = np.random.default_rng(0)
    f0 = np.where(rng.random((3, 50)) < 0.3, 0.0,
                  rng.uniform(60, 300, (3, 50))).astype(np.float32)
    got = tfilters.medfilt3(torch.from_numpy(f0)).numpy()
    for b in range(3):
        np.testing.assert_array_equal(got[b], sp_signal.medfilt(f0[b]))
        np.testing.assert_array_equal(
            got[b], np.asarray(jfilters.medfilt3(jnp.asarray(f0[b]))))
    lf0 = tspectral.f0_to_lf0(torch.from_numpy(f0)).numpy()
    np.testing.assert_allclose(
        lf0, np.asarray(jspectral.f0_to_lf0(jnp.asarray(f0))), rtol=2e-7)
    assert np.all(lf0[f0 == 0] == -1.0e10)


def test_format_for_modelling_matches_jax():
    """format_for_modelling on numpy lossless streams: mel streams to
    5e-5 absolute (float32 matmul round-off), lf0 (host float64) equal."""
    rng = np.random.default_rng(1)
    n, h = 40, 1025
    mag = np.exp(rng.standard_normal((n, h))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (n, h))
    f0 = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(80, 250, n))
    args = (mag, np.cos(ang), np.sin(ang), f0, FS)
    ref = jcompressed.format_for_modelling(*args)
    got = tcompressed.format_for_modelling(*args, device="cpu")
    for i in range(3):
        np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=5e-5)
    np.testing.assert_array_equal(got[3], ref[3])


# ---------------------------------------------------------------------------
# guards

@pytest.mark.parametrize("bad", [
    dict(mesh=object()), dict(feat_dtype=np.int8),
    dict(feat_dtype=np.float64), dict(env="clip")])
def test_unported_analysis_options_raise(bad, monkeypatch):
    """A mesh, any output dtype but float16, float32 and uint8 (int8,
    float64) and a tracker whitening mode that names none of 'none',
    'clipNN' and 'cube' raise ValueError up front."""
    env = bad.pop("env", None)
    if env is not None:
        monkeypatch.setenv("MAGPHASE_TRACKER_WHITEN", env)
    with pytest.raises(ValueError):
        tab.analysis_compressed_batch(_signals()[:1], FS, device="cpu",
                                      **bad)


@pytest.mark.parametrize("fn", [
    tab.analysis_compressed_batch, tab.track_f0_batch, extract_epochs,
    tt.track_f0, tcompressed.format_for_modelling,
    tbatch.synthesis_from_compressed_batch, tab.analysis_lossless_batch,
    tcs.copy_synthesis_batch, tlossless.analysis_lossless,
    tlossless.analysis_with_del_comp_from_pm,
    tlossless.synthesis_from_lossless, tlossless.synthesis_with_del_comp])
def test_public_entries_default_to_the_card(fn):
    """Every public entry of the port runs on the card unless the caller
    asks for the CPU."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entries_run_on_the_cpu_only_when_asked():
    """With no card, the default device fails instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        extract_epochs(_signals()[0], FS)
