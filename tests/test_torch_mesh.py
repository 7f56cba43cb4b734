"""Data parallelism of the port (parallel/mesh.py) against the JAX
package: the mesh helpers, and every batch entry that takes ``mesh=``
with its batch split over 8 logical CPU shards, held against the JAX entry
on its 8-device CPU mesh (tests/conftest.py) and against the port's own
unsplit call; the 3-shard / 2-utterance case; the facade's batch methods.

Split against unsplit on the CPU: the rows of a split are the same rows of
the same tensors, so only how a library call groups rows can change a
value.  MKL's FFT rounds a row by the call's row count in three classes
(1, 2-4, 5+ rows; PERF.md, section 6) and by nothing else here; every FFT and
matmul of these paths runs over (utterances x frames) rows with frames a
bucket of at least 128, so a shard's call (>= 128 rows) falls in the same
class as the whole batch's, and each row's arithmetic is the same: the
derived bound is 0 and the asserts are bitwise.
"""
import inspect

import jax
import numpy as np
import pytest

from magphase_tpu.parallel import analysis_batch as jab
from magphase_tpu.parallel import batch as jbatch
from magphase_tpu.parallel import copy_synthesis as jcs
from magphase_tpu.parallel import mesh as jmesh
from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu_torch.models import MagPhaseVocoder
from magphase_tpu_torch.parallel import analysis_batch as tab
from magphase_tpu_torch.parallel import batch as tbatch
from magphase_tpu_torch.parallel import copy_synthesis as tcs
from magphase_tpu_torch.parallel import mesh as tmesh

FS = 48000
FFT = 512
CPU8 = tmesh.DataMesh(["cpu"] * 8)
CPU3 = tmesh.DataMesh(["cpu"] * 3)
# port vs JAX bounds, as the unsplit tests state them:
# test_torch_slice.py (synthesis, of the peak), test_torch_analysis.py
# (TOL_VS_JAX_ENTRY), test_torch_lossless.py (TOL_MAG_REL of the peak,
# TOL_PHASOR where mag > 1e-3 of the peak; copy-synthesis absolute)
TOL_SYN_REL = 1e-5
TOL_VS_JAX_ENTRY = 5e-4
TOL_MAG_REL = 1e-5
TOL_PHASOR = 1e-4
TOL_COPY = 2e-6


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


def _signals(n=3):
    segs = [[(0.25, 120, 150)], [(0.1, None, None), (0.2, 180, 140)],
            [(0.3, 95, 110)], [(0.15, 220, 200), (0.05, None, None)]]
    return [make_stimulus(FS, segs[i % 4], seed=i)[0] for i in range(n)]


def _epochs(sigs):
    rng = np.random.default_rng(5)
    out = []
    for s in sigs:
        pm = np.cumsum(rng.integers(200, 400, len(s) // 400)) / FS
        pm = pm[pm * FS < len(s) - 400]
        out.append((pm, (rng.random(len(pm)) > 0.3).astype(np.float64)))
    return out


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = (g, r) if isinstance(g, tuple) else ((g,), (r,))
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# helpers

@pytest.mark.parametrize("n", range(1, 9))
def test_budget_helpers_match_jax(n):
    """batch_step, capped_batch_step and budget_batch_cap on a mesh of n
    devices are the JAX package's, and keep the cap: a batch bucketed
    under it never exceeds it and splits evenly over the mesh."""
    jm = jmesh.data_mesh(n)
    tm = tmesh.DataMesh(["cpu"] * n)
    assert tmesh.batch_step(tm) == jmesh.batch_step(jm)
    for raw in (1, 2, 3, 5, 7, 8, 9, 15, 16, 17, 23, 24, 40, 100):
        cap = tmesh.budget_batch_cap(tm, raw)
        assert cap == jmesh.budget_batch_cap(jm, raw)
        step = tmesh.capped_batch_step(tm, cap)
        assert step == jmesh.capped_batch_step(jm, cap)
        for k in range(1, cap + 1):
            b = -(-k // step) * step
            assert b <= max(cap, n) and b % n == 0
        assert tmesh.pad_batch_to_devices(raw, n) == \
            jmesh.pad_batch_to_devices(raw, n)
    assert tmesh.budget_batch_cap(None, 5) == jmesh.budget_batch_cap(None, 5)


@pytest.mark.parametrize("count", [2, 3, 4])
def test_partition_tokens_matches_jax(count):
    """Round-robin and LPT shares are the JAX package's, per process, and
    a disjoint cover."""
    rng = np.random.default_rng(count)
    toks = [f"u{i:03d}" for i in range(23)]
    for weights in (None, list(rng.uniform(1, 9, 23)),
                    [3.0] * 23, list(rng.integers(1, 4, 23).astype(float))):
        shares = []
        for idx in range(count):
            got = tmesh.partition_tokens(toks, idx, count, weights)
            assert got == jmesh.partition_tokens(toks, idx, count, weights)
            shares.append(got)
        assert sorted(sum(shares, [])) == toks
    assert tmesh.partition_tokens(toks, 0, 1) == toks
    with pytest.raises(ValueError):
        tmesh.partition_tokens(toks, 0, 2, [1.0])


def test_shard_batch_layout():
    """shard_batch gives shard i its contiguous block of rows on its
    device (batch_sharding's ranges); run_sharded returns per-shard
    results in shard order; an uneven split and a non-mesh raise."""
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    blocks = tmesh.shard_batch(CPU8, x)
    ranges = tmesh.batch_sharding(CPU8, 2)(8)
    for (d, r), blk in zip(ranges, blocks):
        assert blk.device == d
        np.testing.assert_array_equal(blk.numpy(), x[r.start:r.stop])
    a, b = tmesh.shard_batch(CPU8, x, x[:, 0])
    out = tmesh.run_sharded(lambda u, v, k=0: (u.sum() + k, v), CPU8,
                            [a, b], dict(k=1))
    assert [float(o[0]) for o in out] == [x[i].sum() + 1 for i in range(8)]
    with pytest.raises(ValueError):
        tmesh.shard_batch(CPU3, x)
    with pytest.raises(ValueError):
        tmesh.as_mesh(object(), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA"):
        tmesh.data_mesh()


# ---------------------------------------------------------------------------
# the batch entries over 8 shards

def test_synthesis_over_a_mesh():
    """synthesis_from_compressed_batch over 8 shards: within TOL_SYN_REL
    of the peak of the JAX entry on its 8-device mesh (same keys), and
    bitwise the port's unsplit call (module docstring); the device-buffer
    form is the same rows."""
    utts = _utts(5, 40, 20, 10, seed=0)
    keys = _keys(5)
    ref = jbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=FFT, pf_type="magphase", keys=keys,
        mesh=jmesh.data_mesh())
    got = tbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=FFT, pf_type="magphase", keys=keys, mesh=CPU8)
    whole = tbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=FFT, pf_type="magphase", keys=keys, device="cpu")
    peak = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        assert np.abs(g - r).max() <= TOL_SYN_REL * peak
    _same(got, whole)
    rows, lens = tbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=FFT, pf_type="magphase", keys=keys, mesh=CPU8,
        block_result=False)
    assert len(rows) == len(lens) == 5
    for r, n, w in zip(rows, lens, whole):
        np.testing.assert_array_equal(r[:n].numpy().astype(np.float64), w)


def test_pipelined_synthesis_over_a_mesh():
    """synthesis_batches_pipelined over 8 shards (two batches, PCM16):
    bitwise its unsplit run, batch by batch."""
    utts = _utts(6, 40, 20, 10, seed=3)
    batches = [(utts[:4], _keys(4, 2)), (utts[4:], _keys(2, 3))]
    kw = dict(fft_len=FFT, pcm16=True, consume=lambda rows, host: rows)
    got = list(tbatch.synthesis_batches_pipelined(batches, FS, mesh=CPU8,
                                                  **kw))
    ref = list(tbatch.synthesis_batches_pipelined(batches, FS, device="cpu",
                                                  **kw))
    assert [len(g) for g in got] == [4, 2]
    for g, r in zip(got, ref):
        _same(g, r)


@pytest.mark.parametrize("branch", ["tracked", "epochs"])
def test_compressed_analysis_over_a_mesh(branch):
    """analysis_compressed_batch over 8 shards, tracked and from given
    epochs: the JAX entry's frame counts and shifts on its 8-device mesh,
    streams within TOL_VS_JAX_ENTRY, lf0 to 1e-6 relative; bitwise the
    port's unsplit call."""
    sigs = _signals(3)
    kw = dict(mag_dim=20, phase_dim=10, fft_len=FFT, feat_dtype=np.float32)
    if branch == "epochs":
        kw["epochs"] = _epochs(sigs)
    ref = jab.analysis_compressed_batch(sigs, FS, mesh=jmesh.data_mesh(),
                                        **kw)
    got = tab.analysis_compressed_batch(sigs, FS, mesh=CPU8, **kw)
    whole = tab.analysis_compressed_batch(sigs, FS, device="cpu", **kw)
    for g, r in zip(got, ref):
        assert g[0].shape == r[0].shape
        for i in range(3):
            np.testing.assert_allclose(g[i], r[i], rtol=0,
                                       atol=TOL_VS_JAX_ENTRY)
        np.testing.assert_allclose(g[3], r[3], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g[4], r[4])
    _same(got, whole)


def test_async_analysis_over_a_mesh_uint8():
    """analysis_compressed_batch_async over 8 shards with the uint8
    features: bitwise the unsplit run (the per-(utterance, coefficient)
    encode is row-local)."""
    sigs = _signals(2)
    kw = dict(mag_dim=20, phase_dim=10, fft_len=FFT, feat_dtype=np.uint8)
    got = tab.analysis_compressed_batch_async(sigs, FS, mesh=CPU8, **kw)()
    _same(got, tab.analysis_compressed_batch_async(sigs, FS, device="cpu",
                                                   **kw)())


@pytest.mark.parametrize("branch", ["tracked", "epochs"])
def test_lossless_analysis_over_a_mesh(branch):
    """analysis_lossless_batch over 8 shards: the JAX entry's shifts and
    f0 on its mesh, magnitudes within TOL_MAG_REL of the peak, phasors
    within TOL_PHASOR where the magnitude is above 1e-3 of the peak;
    bitwise the port's unsplit call."""
    sigs = _signals(3)
    kw = dict(fft_len=FFT)
    if branch == "epochs":
        kw["epochs"] = _epochs(sigs)
    ref = jab.analysis_lossless_batch(sigs, FS, mesh=jmesh.data_mesh(), **kw)
    got = tab.analysis_lossless_batch(sigs, FS, mesh=CPU8, **kw)
    whole = tab.analysis_lossless_batch(sigs, FS, device="cpu", **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[4], r[4])
        np.testing.assert_allclose(g[3], r[3], rtol=1e-12, atol=0)
        peak = np.abs(r[0]).max()
        np.testing.assert_allclose(g[0], r[0], rtol=0,
                                   atol=TOL_MAG_REL * peak)
        big = r[0] > 1e-3 * peak
        for i in (1, 2):
            np.testing.assert_allclose(g[i][big], r[i][big], rtol=0,
                                       atol=TOL_PHASOR)
    _same(got, whole)


def test_copy_synthesis_over_a_mesh():
    """copy_synthesis_batch over 8 shards: within TOL_COPY of the JAX
    entry on its mesh, bitwise the port's unsplit call; the device-buffer
    form gives one row and one mark count per shard row."""
    sigs = _signals(3)
    ref = jcs.copy_synthesis_batch(sigs, FS, fft_len=FFT,
                                   mesh=jmesh.data_mesh())
    got = tcs.copy_synthesis_batch(sigs, FS, fft_len=FFT, mesh=CPU8)
    whole = tcs.copy_synthesis_batch(sigs, FS, fft_len=FFT, device="cpu")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL_COPY)
    _same(got, whole)
    rows, counts = tcs.copy_synthesis_batch(sigs, FS, fft_len=FFT, mesh=CPU8,
                                            block_result=False)
    assert len(rows) == len(counts) == 8
    for r, w in zip(rows, whole):
        np.testing.assert_array_equal(r[:len(w)].numpy().astype(np.float64),
                                      w)


def test_mesh_size_not_dividing_the_bucket():
    """3 shards, 2 utterances: the batch bucket is lcm(8, 3) = 24 rows,
    8 a shard; analysis and synthesis equal the JAX entries on a 3-device
    mesh within their bounds and the unsplit calls bitwise."""
    sigs = _signals(2)
    kw = dict(mag_dim=20, phase_dim=10, fft_len=FFT, feat_dtype=np.float32)
    ref = jab.analysis_compressed_batch(sigs, FS, mesh=jmesh.data_mesh(3),
                                        **kw)
    got = tab.analysis_compressed_batch(sigs, FS, mesh=CPU3, **kw)
    for g, r in zip(got, ref):
        for i in range(3):
            np.testing.assert_allclose(g[i], r[i], rtol=0,
                                       atol=TOL_VS_JAX_ENTRY)
        np.testing.assert_array_equal(g[4], r[4])
    _same(got, tab.analysis_compressed_batch(sigs, FS, device="cpu", **kw))
    utts = [u[:4] for u in got]
    keys = _keys(2, 4)
    syn = tbatch.synthesis_from_compressed_batch(utts, FS, fft_len=FFT,
                                                 keys=keys, mesh=CPU3)
    jsyn = jbatch.synthesis_from_compressed_batch(utts, FS, fft_len=FFT,
                                                  keys=keys,
                                                  mesh=jmesh.data_mesh(3))
    peak = max(np.abs(r).max() for r in jsyn)
    for g, r in zip(syn, jsyn):
        assert np.abs(g - r).max() <= TOL_SYN_REL * peak
    _same(syn, tbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=FFT, keys=keys, device="cpu"))


def test_facade_batch_methods_over_a_mesh():
    """MagPhaseVocoder.analyze_batch, analyze_lossless_batch and
    synthesize_batch pass ``mesh`` on: bitwise the unsplit calls."""
    voc = MagPhaseVocoder(fs=FS, fft_len=FFT, mag_dim=20, phase_dim=10,
                          device="cpu")
    sigs = _signals(2)
    feats = voc.analyze_batch(sigs, mesh=CPU3)
    _same(feats, voc.analyze_batch(sigs))
    _same(voc.analyze_lossless_batch(sigs, mesh=CPU3),
          voc.analyze_lossless_batch(sigs))
    utts = [f[:4] for f in feats]
    _same(voc.synthesize_batch(utts, mesh=CPU3), voc.synthesize_batch(utts))
    for name in ("analyze_batch", "analyze_lossless_batch",
                 "synthesize_batch"):
        assert "mesh" in inspect.signature(getattr(voc, name)).parameters


def test_mesh_entries_keep_the_card_default():
    """Every entry that takes a mesh defaults to none, and to the card."""
    for fn in (tbatch.synthesis_from_compressed_batch,
               tbatch.synthesis_batches_pipelined,
               tab.analysis_compressed_batch,
               tab.analysis_compressed_batch_async,
               tab.analysis_lossless_batch, tcs.copy_synthesis_batch):
        sig = inspect.signature(fn).parameters
        assert sig["mesh"].default is None
        assert sig["device"].default == "cuda"
    assert jax.device_count() == 8


def test_launch_counts_from_threads_sum_exactly():
    """The shards of a mesh launch from threads of their own; every
    wrapper's count is taken under a lock, so 8 threads' counts sum
    exactly (a switch interval of 1 us makes a lost update of a bare
    ``+= 1`` likely)."""
    import sys
    import threading
    from magphase_tpu_torch.kernels import _build, dft, framing, walk
    wrappers = [framing.frames, framing.ola, framing.ola_anti_ring,
                walk.walk, dft.rfft_fused, dft.irfft_fused]
    saved = [w.launches for w in wrappers]
    interval = sys.getswitchinterval()
    reps = 3000

    def work():
        for _ in range(reps):
            for w in wrappers:
                _build.count_launch(w)

    try:
        for w in wrappers:
            w.launches = 0
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert [w.launches for w in wrappers] == [8 * reps] * len(wrappers)
    finally:
        sys.setswitchinterval(interval)
        for w, n in zip(wrappers, saved):
            w.launches = n
