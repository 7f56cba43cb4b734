"""The transports and the pipelined entries of the port against the JAX
package: quantise_feats (the int8 upload encoding) bitwise, int8
synthesis, the uint8 analysis encoding, synthesis_batches_pipelined
against the blocking entry, analysis_compressed_batch_async against its
groups, and the signatures of every entry this slice adds.
"""
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from magphase_tpu import cli as jcli
from magphase_tpu import serve as jserve
from magphase_tpu.io import labels as jlabels
from magphase_tpu.io import native as jnative
from magphase_tpu.io import scp as jscp
from magphase_tpu.io import wav as jwav
from magphase_tpu.parallel import analysis_batch as jab
from magphase_tpu.parallel import batch as jbatch
from magphase_tpu.utils import corpus as jcorpus
from magphase_tpu.utils import eval as jeval
from magphase_tpu.utils import metrics as jmetrics
from magphase_tpu.utils import padding as jpadding
from magphase_tpu.utils import pipeline as jpipeline
from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu_torch import cli as tcli
from magphase_tpu_torch import serve as tserve
from magphase_tpu_torch.core import spectral as tspectral
from magphase_tpu_torch.io import labels as tlabels
from magphase_tpu_torch.io import native as tnative
from magphase_tpu_torch.io import scp as tscp
from magphase_tpu_torch.io import wav as twav
from magphase_tpu_torch.parallel import analysis_batch as tab
from magphase_tpu_torch.parallel import batch as tbatch
from magphase_tpu_torch.utils import corpus as tcorpus
from magphase_tpu_torch.utils import eval as teval
from magphase_tpu_torch.utils import metrics as tmetrics
from magphase_tpu_torch.utils import pipeline as tpipeline
from magphase_tpu_torch.vocoder import compressed as tcompressed

FS = 48000
CPU = dict(device="cpu")
SEGMENTS = [[(0.3, 120, 120)],
            [(0.2, None, None), (0.3, 140, 200), (0.15, None, None),
             (0.3, 220, 110), (0.1, None, None)],
            [(0.5, 90, 180)]]


def _utts(n_utts, F, mag_dim, phase_dim, seed):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_utts):
        n = F - 3 * b
        mag = rng.standard_normal((n, mag_dim)).astype(np.float32) * 0.3 - 3.0
        real = np.clip(rng.standard_normal((n, phase_dim)) * 0.3, -1, 1)
        imag = np.clip(rng.standard_normal((n, phase_dim)) * 0.3, -1, 1)
        lf0 = np.log(rng.uniform(90, 250, n))
        lf0[rng.random(n) < 0.3] = -1.0e10
        out.append((mag, real, imag, lf0))
    return out


def _keys(n, seed=1):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2),
                                                dtype=np.uint32)


@pytest.fixture(scope="module")
def signals():
    return [make_stimulus(FS, s, seed=1)[0] for s in SEGMENTS]


# ---------------------------------------------------------------------------
# int8 synthesis transport

@pytest.mark.parametrize("seed", [0, 1])
def test_quantise_feats_bitwise_jax(seed):
    """numpy in both packages: the same codes, scales and zero points (F4:
    both dequantise the same uint8 codes), a constant column included."""
    rng = np.random.default_rng(seed)
    B, F, D = 3, 50, 12
    x = (rng.standard_normal((B, F, D)) * np.linspace(0.5, 20, D)
         ).astype(np.float16)
    x[1, :, 3] = 2.5
    nfrms = np.asarray([50, 17, 1])
    got = tbatch.quantise_feats(x, nfrms)
    ref = jbatch.quantise_feats(x, nfrms)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_prepare_group_int8_matches_jax():
    """The int8 group's host arrays: the JAX package's, array for array."""
    utts = _utts(3, 64, 20, 10, seed=1)
    keys = _keys(3)
    fft_syn, max_b = tbatch._synthesis_geometry(utts, FS, 4096, True)
    got = tbatch._prepare_synthesis_group(
        utts, n_real=3, keys=keys, max_b=max_b, fs=FS, mag_dim=20,
        phase_dim=10, transport="int8")
    ref = jbatch._prepare_synthesis_group(
        utts, n_real=3, keys=keys, mesh=None, max_b=max_b, fs=FS,
        fft_syn=fft_syn, alpha=0.77, alpha_phase=0.77, mag_dim=20,
        phase_dim=10, mag_dim_ph=0, b_voi_ap_win=True,
        per_phase_type="magphase", b_out_hpf=True, pf_type="no",
        transport="int8")
    for name, r in (("feats", ref["args"][0]), ("q_scale", ref["extra"][0]),
                    ("q_zp", ref["extra"][1])):
        assert got[name].dtype == r.dtype, name
        np.testing.assert_array_equal(got[name], r, err_msg=name)


@pytest.mark.parametrize("pf_type", ["no", "magphase"])
def test_int8_synthesis_matches_jax(pf_type):
    """transport='int8' end to end with the same keys: within 1e-5 of the
    peak of the JAX output (the f16 transport's bound,
    tests/test_torch_slice.py; dequantisation is q * scale + zp in float32
    in both), and close to the port's own f16 output (the JAX package's
    bound for int8 against f16, tests/test_transfer_encodings.py: 2%
    relative RMS)."""
    utts = _utts(3, 64, 20, 10, seed=0)
    keys = _keys(3)
    kw = dict(fft_len=512, pf_type=pf_type, keys=keys, transport="int8")
    ref = jbatch.synthesis_from_compressed_batch(utts, FS, **kw)
    got = tbatch.synthesis_from_compressed_batch(utts, FS, **kw, **CPU)
    f16 = tbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=512, pf_type=pf_type, keys=keys, **CPU)
    peak = max(np.abs(r).max() for r in ref)
    for g, r, h in zip(got, ref, f16):
        assert g.shape == r.shape == h.shape
        assert np.abs(g - r).max() <= 1e-5 * peak
        rel = np.sqrt(np.mean((g - h) ** 2)) / np.sqrt(np.mean(h ** 2))
        assert 0 < rel < 0.02, rel


# ---------------------------------------------------------------------------
# uint8 analysis features

def test_uint8_codes_within_one_step_of_jax(signals, monkeypatch):
    """Phase 2 on the JAX tracker's marks in both packages (the JAX side
    with the native rfft, so the float32 streams agree to ~1e-4), then
    each package's uint8 encode: codes within one step, the scales and
    zero points to float32 round-off of the streams; the port's codes
    dequantise within half a scale of its own float32 streams."""
    _, (s, ns, nf), _, Tmax, m_max, _ = jab._host_signal_batch(
        signals, FS, None, fft_len=2048)
    s = np.asarray(jab._sigs_f32(jnp.asarray(s)))
    marks, flags, n_marks = (np.asarray(a) for a in jab._track_place_kernel(
        jnp.asarray(s), jnp.asarray(ns), jnp.asarray(nf), fs=FS,
        n_frames_max=Tmax, m_max=m_max))
    F = jpadding.bucket_frames(int(n_marks.max()))
    mag_dim_ph = tcompressed.get_num_full_mel_coeffs_from_num_phase_coeffs(
        5000.0, 45, 0.77, FS)
    ckw = dict(fs=FS, fft_len=2048, F=F, mag_dim=60, phase_dim=45,
               mag_dim_ph=mag_dim_ph, alpha=0.77, alpha_phase=0.77)
    # eager (not the jitted kernel, whose cache ignores the variable)
    monkeypatch.setenv("MAGPHASE_ANALYSIS_RFFT", "native")
    q_r, szp_r, _aux, _nv = (np.asarray(a) for a in jab._analyze_compress_impl(
        jnp.asarray(s), jnp.asarray(marks), jnp.asarray(flags),
        jnp.asarray(n_marks), jnp.asarray(ns), feats_f16="u8", pack=True,
        **ckw))
    *streams, n_valid = tab._analyze_compress_impl(
        *(torch.from_numpy(np.array(a)) for a in (s, marks, flags, n_marks,
                                                  ns)), **ckw)
    q, scale, lo = (x.numpy() for x in tab._encode_u8(*streams[:3],
                                                      n_valid))
    v = np.arange(F)[None, :] < n_marks[:, None]
    assert q.dtype == np.uint8
    d = np.abs(q.astype(np.int32) - q_r.astype(np.int32))[v]
    assert d.max() <= 1, d.max()
    np.testing.assert_allclose(scale, szp_r[:, 0], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(lo, szp_r[:, 1], rtol=0, atol=5e-4)
    f32 = torch.cat(streams[:3], dim=-1).numpy()
    deq = q.astype(np.float64) * scale[:, None, :] + lo[:, None, :]
    err = np.abs(deq - f32)[v]
    half = np.broadcast_to(scale[:, None, :], deq.shape)[v] / 2
    assert np.all(err <= half * (1 + 1e-5) + 1e-6)


def test_uint8_analysis_matches_jax(signals):
    """analysis_compressed_batch(feat_dtype=np.uint8) end to end: the same
    shapes and shifts, lf0 as the float paths', and each dequantised
    stream value within one code step (the coefficient's scale) plus the
    float32 bound of the tracked branch (5e-4) of the JAX value."""
    ref = jab.analysis_compressed_batch(signals, FS, fft_len=2048,
                                        feat_dtype=np.uint8)
    got = tab.analysis_compressed_batch(signals, FS, fft_len=2048,
                                        feat_dtype=np.uint8, **CPU)
    f32 = tab.analysis_compressed_batch(signals, FS, fft_len=2048,
                                        feat_dtype=np.float32, **CPU)
    for g, r, f in zip(got, ref, f32):
        feats_g = np.concatenate(g[:3], axis=1)
        feats_r = np.concatenate(r[:3], axis=1)
        assert feats_g.shape == feats_r.shape
        span = feats_r.max(axis=0) - feats_r.min(axis=0)
        step = np.where(span > 0, span / 255.0, 1.0)
        assert np.all(np.abs(feats_g - feats_r) <= step + 5e-4)
        np.testing.assert_allclose(g[3], r[3], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g[4], r[4])
        np.testing.assert_array_equal(g[3], f[3])
        np.testing.assert_array_equal(g[4], f[4])
        assert np.all(np.abs(feats_g - np.concatenate(f[:3], axis=1))
                      <= step / 2 * (1 + 1e-5) + 1e-6)


def test_uint8_const_rate_falls_back_to_float16(signals):
    """At the constant frame rate uint8 gives the float16 output, as in the
    JAX package."""
    kw = dict(fft_len=2048, b_const_rate=True, **CPU)
    u8 = tab.analysis_compressed_batch(signals[:2], FS, feat_dtype=np.uint8,
                                       **kw)
    f16 = tab.analysis_compressed_batch(signals[:2], FS, **kw)
    for a, b in zip(u8, f16):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the pipelined entries

@pytest.mark.parametrize("pcm16,transport", [(True, "f16"), (False, "int8")])
def test_synthesis_pipelined_equals_blocking(monkeypatch, pcm16, transport):
    """synthesis_batches_pipelined over three batches (one split into two
    groups under a small frame budget) against the blocking entry on the
    same groups: bitwise, in order, with the tags and lengths handed to
    consume."""
    utts = _utts(7, 48, 20, 10, seed=4)
    fft_syn = tbatch._synthesis_geometry(utts, FS, 512, True)[0]
    monkeypatch.setattr(tbatch, "MAX_FRAME_ELEMS", 2 * 128 * fft_syn)
    keys = _keys(7, 5)
    spans = [(0, 2), (2, 6), (6, 7)]
    batches = [(utts[a:b], keys[a:b], f"batch{a}") for a, b in spans]
    kw = dict(fft_len=512, pf_type="magphase", transport=transport, **CPU)
    seen = []

    def consume(rows, host):
        seen.append((host["tag"], [len(r) for r in rows],
                     host["out_lens"][:host["n_real"]]))
        return rows

    got = [r for g in tbatch.synthesis_batches_pipelined(
        batches, FS, pcm16=pcm16, consume=consume, **kw) for r in g]
    ref = []
    for a, b in spans:
        r = tbatch.synthesis_from_compressed_batch(
            utts[a:b], FS, keys=keys[a:b], det_fft_syn=True,
            block_result=not pcm16, pcm16=pcm16, **kw)
        if pcm16:
            bufs, lens = r
            r = [bufs[i][:n].numpy() for i, n in enumerate(lens)]
        ref.extend(r)
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        assert g.dtype == (np.int16 if pcm16 else np.float32)
        np.testing.assert_array_equal(g, np.asarray(r, g.dtype))
    assert [t for t, _, _ in seen] == [("batch0", 0), ("batch2", 0),
                                       ("batch2", 2), ("batch6", 0)]
    assert all(n == list(lens) for _, n, lens in seen)


def test_synthesis_pipelined_default_is_float64_waveforms():
    utts = _utts(2, 40, 20, 10, seed=6)
    keys = _keys(2)
    got = [w for g in tbatch.synthesis_batches_pipelined(
        [(utts, keys)], FS, fft_len=512, **CPU) for w in g]
    ref = tbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=512, keys=keys, det_fft_syn=True, **CPU)
    for g, r in zip(got, ref):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, r)


def test_synthesis_pipelined_stage_error_propagates(monkeypatch):
    """A stage that raises tears the pipeline down and re-raises."""
    def boom(*a, **kw):
        raise RuntimeError("execute failed")

    monkeypatch.setattr(tbatch, "_execute_synthesis_group", boom)
    utts = _utts(2, 40, 20, 10, seed=6)
    with pytest.raises(RuntimeError, match="execute failed"):
        list(tbatch.synthesis_batches_pipelined(
            [(utts, _keys(2))], FS, fft_len=512, **CPU))
    with pytest.raises(ValueError):
        list(tbatch.synthesis_batches_pipelined(
            [(utts, _keys(2))], FS, transport="u8", **CPU))


@pytest.mark.parametrize("feat_dtype", [np.float32, np.float16])
def test_analysis_async_equals_its_groups(signals, monkeypatch, feat_dtype):
    """analysis_compressed_batch_async over a request the budget splits
    into two groups: bitwise each group's own async run, in order; and
    analysis_compressed_batch (which runs through it) returns the same."""
    kw = dict(fft_len=2048, feat_dtype=feat_dtype, **CPU)
    sigs = signals + signals[:1]
    m_max = tab._budget_geometry(sigs, FS, 2048)[1]
    monkeypatch.setattr(tab, "MAX_FRAME_ELEMS", 2 * m_max * 2048)
    groups = tab._split_for_budget(sigs, FS, 2048)
    assert [len(g) for g in groups] == [2, 2]
    fin = tab.analysis_compressed_batch_async(sigs, FS, **kw)
    whole = fin()
    parts = [u for g in groups
             for u in tab.analysis_compressed_batch_async(g, FS, **kw)()]
    sync = tab.analysis_compressed_batch(sigs, FS, **kw)
    assert len(whole) == len(parts) == len(sync) == 4
    for a, b, c in zip(whole, parts, sync):
        for x, y, z in zip(a, b, c):
            assert x.dtype == y.dtype == z.dtype
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def test_analysis_async_float16_is_float32_rounded(signals):
    kw = dict(fft_len=2048, **CPU)
    f16 = tab.analysis_compressed_batch_async(signals, FS, **kw)()
    f32 = tab.analysis_compressed_batch_async(signals, FS,
                                              feat_dtype=np.float32, **kw)()
    for a, b in zip(f16, f32):
        for i in range(3):
            np.testing.assert_array_equal(
                a[i], b[i].astype(np.float16).astype(np.float64))
        np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_array_equal(a[4], b[4])


def test_analysis_async_stage_error_raises_in_finalize(signals,
                                                       monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("phase 1 failed")

    monkeypatch.setattr(tab, "_track_place_impl", boom)
    fin = tab.analysis_compressed_batch_async(signals[:1], FS, fft_len=2048,
                                              **CPU)
    with pytest.raises(RuntimeError, match="phase 1 failed"):
        fin()


# ---------------------------------------------------------------------------
# signatures

def _params(fn):
    """Positional-or-keyword parameters, in order, with their defaults."""
    return [(n, p.default) for n, p in inspect.signature(fn).parameters.items()
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.VAR_POSITIONAL)]


def _same(a, b):
    return a == b or (isinstance(a, type) and np.dtype(a) == np.dtype(b))


@pytest.mark.parametrize("pair", [
    (jbatch.synthesis_batches_pipelined, tbatch.synthesis_batches_pipelined),
    (jbatch.quantise_feats, tbatch.quantise_feats),
    (jab.analysis_compressed_batch_async,
     tab.analysis_compressed_batch_async),
    (jab.analysis_compressed_batch, tab.analysis_compressed_batch),
    (jcli.main, tcli.main), (jcli.cmd_extract, tcli.cmd_extract),
    (jcli.cmd_generate, tcli.cmd_generate), (jcli.cmd_eval, tcli.cmd_eval),
    (jcli.cmd_convert_labels, tcli.cmd_convert_labels),
    (jcli.cmd_serve, tcli.cmd_serve),
    (jcli._host_partition, tcli._host_partition),
    (jcli._maybe_mesh, tcli._maybe_mesh),
    (jserve.serve_forever, tserve.serve_forever),
    (jserve.request, tserve.request),
    (jscp.read_scp_file, tscp.read_scp_file),
    (jscp.gen_list_of_file_paths, tscp.gen_list_of_file_paths),
    (jscp.get_file_list, tscp.get_file_list),
    (jscp.get_filename, tscp.get_filename), (jscp.mkdir, tscp.mkdir),
    (jwav.write_wav_pcm16, twav.write_wav_pcm16),
    (jlabels.load_state_times, tlabels.load_state_times),
    (jlabels.get_num_of_frms_per_state, tlabels.get_num_of_frms_per_state),
    (jlabels.get_num_of_frms_per_phon_unit,
     tlabels.get_num_of_frms_per_phon_unit),
    (jlabels.frame_to_state_mapping, tlabels.frame_to_state_mapping),
    (jlabels.convert_label_state_align_to_var_frame_rate,
     tlabels.convert_label_state_align_to_var_frame_rate),
    (jnative.read_wav, tnative.read_wav),
    (jnative.batch_read_wavs, tnative.batch_read_wavs),
    (jnative.read_binfile, tnative.read_binfile),
    (jnative.write_wav, tnative.write_wav),
    (jnative.available, tnative.available),
    (jpipeline.run_staged, tpipeline.run_staged),
    (jcorpus.run_corpus, tcorpus.run_corpus),
    (jcorpus.run_corpus_batched, tcorpus.run_corpus_batched),
    (jcorpus.Manifest, tcorpus.Manifest),
    (jmetrics.Metrics.summary, tmetrics.Metrics.summary),
    (jmetrics.profile_trace, tmetrics.profile_trace),
    (jmetrics.setup_logging, tmetrics.setup_logging),
    (jeval.log_mel_spectrogram, teval.log_mel_spectrogram),
    (jeval.align_by_xcorr, teval.align_by_xcorr),
    (jeval.mel_spectral_distortion, teval.mel_spectral_distortion),
    (jeval.mel_spectral_distortion_piecewise,
     teval.mel_spectral_distortion_piecewise),
    (jeval.log_spectral_distortion_feats,
     teval.log_spectral_distortion_feats)],
    ids=lambda pair: (f"{pair[1].__module__.split('.')[-1]}."
                      f"{pair[1].__qualname__}"))
def test_signature_matches_jax(pair):
    """The port's positional parameters are the JAX entry's, in order,
    with the same defaults; the port adds keyword-only ``device`` where
    its work runs on a device."""
    ref, got = (_params(f) for f in pair)
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (n, a), (_, b) in zip(got, ref):
        assert _same(a, b), (n, a, b)


def _witness_signal(seconds=3.0, seed=2000):
    """One signal of chip_smoke.py's witness corpus."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.make_witness_signals(np.random.default_rng(seed), 1,
                                   seconds)[0][0]


def test_int8_msd_matches_jax():
    """int8 against f16 synthesis of the features of one witness signal of
    chip_smoke.py's CLI phase, in both packages with the same key: the
    port's MSD between the two equals the JAX package's within 0.01 dB and
    the relative RMS of both stays under the JAX package's 0.02.  The JAX
    package's own MSD here is above its 0.5 dB bound of
    tests/test_transfer_encodings.py (measured 0.586 dB), a bound taken on
    its demo corpus: that is why chip_smoke.py holds the card's int8 wavs
    to the CPU's and to the relative RMS bound, not to 0.5 dB."""
    sig = _witness_signal()
    feats = [f[:4] for f in jab.analysis_compressed_batch([sig], FS)]
    keys = _keys(1, 9)
    msd, rel = {}, {}
    for name, fn, kw in (("jax", jbatch.synthesis_from_compressed_batch, {}),
                         ("port", tbatch.synthesis_from_compressed_batch,
                          CPU)):
        f16, i8 = (fn(feats, FS, pf_type="magphase", keys=keys,
                      transport=tr, **kw)[0] for tr in ("f16", "int8"))
        msd[name] = jeval.mel_spectral_distortion(i8, f16, FS)
        rel[name] = float(np.sqrt(np.mean((i8 - f16) ** 2))
                          / np.sqrt(np.mean(f16 ** 2)))
    assert abs(msd["port"] - msd["jax"]) < 0.01, msd
    assert max(rel.values()) < 0.02, rel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_synthesis_does_not_depend_on_the_batch_on_the_card(cuda_device):
    """An utterance's PCM16 rows are bitwise the same in groups of another
    size (16 against 8), another frame bucket, and at another place in the
    group (in the second of the FFTs' fixed-size calls): every stage's
    per-row result is independent of the batch's shape on the card, the
    noise gain's sum (an exact fixed-point sum) and the FFTs (calls of a
    fixed row count) included."""
    utts = _utts(16, 64, 60, 45, seed=8)
    utts.append(_utts(1, 300, 60, 45, seed=9)[0])
    keys = _keys(17, 2)
    kw = dict(fft_len=4096, pf_type="magphase", det_fft_syn=True,
              block_result=False, pcm16=True, device=cuda_device)
    rows = {}
    for name, sel in (("b16", list(range(16))), ("b5", list(range(5))),
                      ("long", [0, 16]), ("late", [16] * 11 + [0])):
        bufs, lens = tbatch.synthesis_from_compressed_batch(
            [utts[i] for i in sel], FS, keys=keys[sel], **kw)
        j = sel.index(0)
        rows[name] = bufs[j, :lens[j]].cpu()
    for name in ("b5", "long", "late"):
        assert torch.equal(rows["b16"], rows[name]), name


@pytest.mark.parametrize("n,per_call", [(5019, 100), (100, 100), (37, 64)])
def test_fft_in_calls_reassembles_the_rows(n, per_call):
    """The synthesis FFTs' fixed-size calls (core/spectral.py, taken
    on the card): padded, split and put back in order, bitwise the one
    call's rows (the CPU's FFT does not depend on the batch)."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, 64)).astype(np.float32))
    spec = torch.fft.rfft(x)
    got = tspectral.fft_in_calls(torch.fft.rfft, x, per_call)
    assert torch.equal(got, spec)
    back = tspectral.fft_in_calls(torch.fft.irfft, spec, per_call, n=64)
    assert torch.equal(back, torch.fft.irfft(spec, n=64))
