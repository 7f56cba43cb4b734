"""The port's slice as a whole against the JAX package: batched compressed
synthesis (the serving path) through synthesis_from_compressed_batch, and
the lossless analysis/synthesis round trip; plus the guards that keep the
port free of JAX and its configuration surface explicit.
"""
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import magphase_tpu_torch
from magphase_tpu.parallel import batch as jbatch
from magphase_tpu.vocoder import lossless as jlossless
from magphase_tpu_torch.parallel import batch as tbatch
from magphase_tpu_torch.vocoder import lossless as tlossless

FS = 48000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.mark.parametrize("pf_type,dims", [("no", (20, 10)),
                                          ("magphase", (20, 10)),
                                          ("merlin", (20, 10)),
                                          ("magphase", (60, 45))])
def test_synthesis_from_compressed_batch_matches_jax(pf_type, dims):
    """The serving path end to end with the same keys= in both packages.
    Measured max|port - jax| <= 1.8e-6 of the peak over pf_type x
    per_phase_type x {20/10, 60/45} at these sizes; bound 1e-5 of the
    peak: float32 FFT round-off between pocketfft builds, noise-gain sums
    in another order, and <= 1 ulp libm differences in the windows."""
    utts = _utts(3, 64, *dims, seed=0)
    keys = _keys(3)
    ref = jbatch.synthesis_from_compressed_batch(utts, FS, fft_len=512,
                                                 pf_type=pf_type, keys=keys)
    got = tbatch.synthesis_from_compressed_batch(utts, FS, fft_len=512,
                                                 pf_type=pf_type, keys=keys,
                                                 device="cpu")
    assert [len(g) for g in got] == [len(r) for r in ref]
    peak = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.float64
        assert np.all(np.isfinite(g))
        assert np.abs(g - r).max() <= 1e-5 * peak


def test_budget_split_matches_one_group(monkeypatch):
    """A request larger than the frame-element budget is split into
    sequential groups; with the content-independent FFT size each
    utterance's audio does not depend on the split (per-utterance keys,
    per-frame high-pass).  Bound 1e-7 of the peak: only the row count of
    the batched FFTs and matmuls changes."""
    utts = _utts(5, 40, 20, 10, seed=2)
    keys = _keys(5, 3)
    kw = dict(fft_len=512, keys=keys, det_fft_syn=True, device="cpu")
    whole = tbatch.synthesis_from_compressed_batch(utts, FS, **kw)
    monkeypatch.setattr(tbatch, "MAX_FRAME_ELEMS", 2 * 128 * 512)
    assert tbatch._synthesis_geometry(utts, FS, 512, True)[1] == 2
    split = tbatch.synthesis_from_compressed_batch(utts, FS, **kw)
    rows, lens = tbatch.synthesis_from_compressed_batch(
        utts, FS, block_result=False, **kw)
    assert len(rows) == len(lens) == 5
    peak = max(np.abs(w).max() for w in whole)
    for w, s, r, n in zip(whole, split, rows, lens):
        assert len(w) == len(s) == n
        np.testing.assert_allclose(s, w, rtol=0, atol=1e-7 * peak)
        np.testing.assert_array_equal(r[:n].numpy().astype(np.float64), s)


def test_pcm16_encode_matches_jax():
    """Device PCM16 encode of the OLA buffers: same float32 input, same
    int16 output bit for bit (round half to even, clip)."""
    utts = _utts(3, 48, 20, 10, seed=4)
    bufs, lens = tbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=512, keys=_keys(3), block_result=False,
        device="cpu")
    lens_t = torch.tensor(lens + [1] * (bufs.shape[0] - len(lens)))
    got = tbatch._pcm16_kernel(bufs, lens_t).numpy()
    ref = np.asarray(jbatch._pcm16_kernel(jnp.asarray(bufs.numpy()),
                                          jnp.asarray(lens_t.numpy())))
    np.testing.assert_array_equal(got, ref)
    q, q_lens = tbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=512, keys=_keys(3), block_result=False,
        pcm16=True, device="cpu")
    assert q.dtype == torch.int16 and q_lens == lens
    np.testing.assert_array_equal(q.numpy()[:3], got[:3])


# ---------------------------------------------------------------------------
# lossless round trip

def _witness(seed, n_utts=2, n_sig=24000):
    """Voiced pulse trains (f0 80-300 Hz) and unvoiced noise runs with
    their exact pitch marks; fft_len 2048 holds every two-period frame."""
    rng = np.random.default_rng(seed)
    sigs, pms, vois = [], [], []
    for _ in range(n_utts):
        pm, voi, t = [], [], int(rng.integers(100, 300))
        while t < n_sig - 700:
            v = (t // 6000) % 3 != 2
            pm.append(t)
            voi.append(float(v))
            t += int(FS / rng.uniform(80, 300)) if v else 240
        x = 0.05 * rng.standard_normal(n_sig)
        x[np.asarray(pm)[np.asarray(voi) > 0]] += 0.5
        x = np.convolve(x, np.exp(-np.arange(200) / 40.0))[:n_sig]
        sigs.append((0.3 * x / np.abs(x).max()).astype(np.float32))
        pms.append(np.asarray(pm, np.int32))
        vois.append(np.asarray(voi, np.float32))
    B, F = n_utts, 256
    sig = np.stack(sigs)
    pm = np.zeros((B, F), np.int32)
    voi = np.zeros((B, F), np.float32)
    for b in range(B):
        pm[b, :len(pms[b])] = pms[b]
        voi[b, :len(vois[b])] = vois[b]
    nfrms = np.asarray([len(p) for p in pms], np.int32)
    n_sigs = np.full(B, n_sig, np.int32)
    return sig, pm, nfrms, n_sigs, voi


def test_lossless_round_trip_reconstructs():
    """analysis_core_batch -> synthesis_core_batch through K1 and K2's
    plain versions: p99 |syn - sig| below one PCM16 step (2^-15) away from
    the edges, the bar of bench.py's witness."""
    sig, pm, nfrms, n_sigs, voi = _witness(5)
    t = [torch.from_numpy(a) for a in (sig, pm, nfrms, n_sigs, voi)]
    mag, real, imag, _f0, _shift = tlossless.analysis_core_batch(
        *t, fft_len=2048, fs=FS)
    out = tlossless.synthesis_core_batch(mag, real, imag, t[1], t[2],
                                         fft_len=2048,
                                         out_len_max=sig.shape[1]).numpy()
    for b in range(sig.shape[0]):
        err = np.abs(out[b] - sig[b])[2000:-2000]
        assert np.all(np.isfinite(out[b]))
        assert np.percentile(err, 99) < 2.0 ** -15


def test_lossless_analysis_features_match_jax():
    """Lossless features vs the JAX package: shift exact, f0 to float32
    round-off; magnitude to 1e-5 of the peak (float32 rfft round-off);
    the normalised phasor to 1e-4 where the magnitude is above 1e-3 of the
    peak (below it the direction of a near-zero bin is round-off)."""
    sig, pm, nfrms, n_sigs, voi = _witness(6)
    kw = dict(fft_len=2048, fs=FS)
    got = tlossless.analysis_core_batch(
        *(torch.from_numpy(a) for a in (sig, pm, nfrms, n_sigs, voi)), **kw)
    ref = jax.jit(jlossless.analysis_core_batch, static_argnames=(
        "fft_len", "fs"))(*(jnp.asarray(a) for a in (sig, pm, nfrms, n_sigs,
                                                      voi)), **kw)
    mag, real, imag, f0, shift = (g.numpy() for g in got)
    rmag, rreal, rimag, rf0, rshift = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(shift, rshift)
    np.testing.assert_allclose(f0, rf0, rtol=1e-6, atol=0)
    peak = rmag.max()
    np.testing.assert_allclose(mag, rmag, rtol=0, atol=1e-5 * peak)
    big = rmag > 1e-3 * peak
    np.testing.assert_allclose(real[big], rreal[big], rtol=0, atol=1e-4)
    np.testing.assert_allclose(imag[big], rimag[big], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# guards

def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        magphase_tpu_torch.__path__, "magphase_tpu_torch."))


def test_port_never_imports_jax():
    """Importing the port and every one of its modules leaves jax (and the
    JAX package) out of sys.modules."""
    mods = ["magphase_tpu_torch"] + _port_modules()
    assert {"magphase_tpu_torch.kernels.framing",
            "magphase_tpu_torch.kernels.dft", "magphase_tpu_torch.io.wav",
            "magphase_tpu_torch.parallel.copy_synthesis"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'magphase_tpu.'))]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_jax_import():
    """No source line of the port (or of chip_smoke.py) imports jax or the
    JAX package, not even inside a function."""
    import re
    pat = re.compile(r"^\s*(?:import\s+(?:jax|magphase_tpu)\b(?!_torch)|"
                     r"from\s+(?:jax|magphase_tpu)\b(?!_torch))")
    root = os.path.dirname(magphase_tpu_torch.__file__)
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30
    bad = [f"{path}:{i}" for path in files
           for i, line in enumerate(open(path), 1) if pat.match(line)]
    assert not bad, bad


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a CUDA
    card, and likewise from a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(lone), str(tmp_path))):
        res = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


@pytest.mark.parametrize("bad", [
    dict(transport="u8"), dict(mesh=object()),
    dict(pcm16=True), dict(pf_type="bogus"), dict(per_phase_type="bogus"),
    dict(env="fir"), dict(env="spectral ")])
def test_unported_options_raise(bad, monkeypatch):
    """A transport other than 'f16' and 'int8', a mesh, pcm16 with
    blocking results, unknown filter/phase types and any
    MAGPHASE_HPF_MODE other than 'spectral' and 'blocked' (a typo) raise
    ValueError up front."""
    utts = _utts(2, 32, 20, 10, seed=7)
    kw = dict(fft_len=512, keys=_keys(2), device="cpu")
    env = bad.pop("env", None)
    if env is not None:
        monkeypatch.setenv("MAGPHASE_HPF_MODE", env)
    kw.update(bad)
    with pytest.raises(ValueError):
        tbatch.synthesis_from_compressed_batch(utts, FS, **kw)
