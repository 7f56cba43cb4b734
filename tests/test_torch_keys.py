"""The port's noise keys and public API against the JAX package:
utils/keys.py (threefry-2x32 in numpy) bit for bit against jax.random,
the key= derivation of synthesis_from_compressed_batch, its signature, and
the package's exports, and that importing the package builds no kernel.
"""
import inspect
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import magphase_tpu
import magphase_tpu.epochs
import magphase_tpu.ops
import magphase_tpu.parallel
import magphase_tpu.utils
import magphase_tpu.vocoder
import magphase_tpu_torch
import magphase_tpu_torch.epochs
import magphase_tpu_torch.ops
import magphase_tpu_torch.parallel
import magphase_tpu_torch.utils
from magphase_tpu.parallel import batch as jbatch
from magphase_tpu_torch.parallel import batch as tbatch
from magphase_tpu_torch.kernels import _build
from magphase_tpu_torch.utils import keys as K

FS = 48000
SEEDS = [0, 1, 42, 2 ** 31 - 1]


def _utts(n_utts, F, mag_dim, phase_dim, seed):
    """Synthetic compressed features, ~30% unvoiced frames (the inputs of
    tests/test_torch_slice.py)."""
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


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    ref = np.asarray(jax.random.PRNGKey(seed), np.uint32)
    got = K.prng_key(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [1, 2, 7, 128, 1000])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, n):
    """split(prng_key(seed), n) is jax.random.split(PRNGKey(seed), n) bit
    for bit (threefry2x32, the partitionable split of JAX's default
    configuration)."""
    ref = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n),
                     np.uint32)
    got = K.split(K.prng_key(seed), n)
    assert got.dtype == np.uint32 and got.shape == (n, 2)
    np.testing.assert_array_equal(got, ref)


def test_split_of_a_child_key_matches_jax():
    """Splitting a key that is itself a split's output (a key with both
    words set) agrees with JAX too."""
    child = K.split(K.prng_key(3), 4)[2]
    ref = np.asarray(jax.random.split(jax.numpy.asarray(child), 9),
                     np.uint32)
    np.testing.assert_array_equal(K.split(child, 9), ref)


def test_split_is_prefix_stable():
    """split(k, m)[i] == split(k, n)[i] for i < min(m, n): a batch cut into
    groups gives each utterance the key it has in the whole batch."""
    key = K.prng_key(11)
    whole = K.split(key, 300)
    for m in (1, 5, 64, 299):
        np.testing.assert_array_equal(K.split(key, m), whole[:m])


@pytest.mark.parametrize("shape,lo,hi", [
    ((1,), 0.0, 1.0), ((7,), -1.0, 1.0), ((1001,), -1.0, 1.0),
    ((5, 13), 0.0, 1.0), ((3, 4, 5), -2.5, 0.5), ((65537,), -1.0, 1.0)],
    ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape, lo, hi):
    """uniform(key, shape, lo, hi) is jax.random.uniform(key, shape,
    float32, lo, hi) bit for bit, for a root key and a split child, odd
    sizes included."""
    for key in (K.prng_key(seed), K.split(K.prng_key(seed), 3)[2]):
        ref = np.asarray(jax.random.uniform(jax.numpy.asarray(key), shape,
                                            minval=lo, maxval=hi))
        got = K.uniform(key, shape, lo, hi)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))


@pytest.mark.parametrize("shape,lo,hi", [
    ((163840,), -1.0, 1.0), ((64, 4096), 0.0, 1.0), ((7,), -2.5, 0.5)],
    ids=str)
def test_uniform_tensor_is_uniform(shape, lo, hi):
    """The torch form (the one the variants and Griffin-Lim draw on their
    device) gives uniform's values bit for bit."""
    for key in (K.prng_key(4), K.split(K.prng_key(9), 2)[1]):
        got = K.uniform_tensor(key, shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      K.uniform(key, shape, lo, hi)
                                      .view(np.uint32))


@pytest.mark.cuda
def test_cuda_uniform_tensor_is_uniform():
    """The same draw on the card, bit for bit."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    key = K.split(K.prng_key(4), 3)[2]
    got = K.uniform_tensor(key, (640, 4096), -1.0, 1.0,
                           device="cuda").cpu().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), K.uniform(
        key, (640, 4096), -1.0, 1.0).view(np.uint32))


def test_uniform_is_prefix_stable():
    """A draw is a prefix of any longer draw from the same key (the
    counter of element i is (0, i)), as JAX's partitionable threefry
    gives: the variants draw at the JAX package's padded shapes."""
    key = K.prng_key(8)
    whole = K.uniform(key, (4096,), -1.0, 1.0)
    for n in (1, 77, 4095):
        np.testing.assert_array_equal(K.uniform(key, (n,), -1.0, 1.0),
                                      whole[:n])


def _assert_audio_close(got, ref):
    """The bound and reason of test_torch_slice.py::
    test_synthesis_from_compressed_batch_matches_jax: 1e-5 of the peak
    (float32 FFT round-off between pocketfft builds, noise-gain sums in
    another order, <= 1 ulp libm differences in the windows)."""
    assert [len(g) for g in got] == [len(r) for r in ref]
    peak = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert np.all(np.isfinite(g))
        assert np.abs(g - r).max() <= 1e-5 * peak


def test_synthesis_without_key_or_keys_matches_jax():
    """Neither key= nor keys=: both packages derive the per-utterance keys
    from PRNGKey(0) and give the same audio."""
    utts = _utts(3, 64, 20, 10, seed=0)
    ref = jbatch.synthesis_from_compressed_batch(utts, FS, fft_len=512,
                                                 pf_type="magphase")
    got = tbatch.synthesis_from_compressed_batch(utts, FS, fft_len=512,
                                                 pf_type="magphase",
                                                 device="cpu")
    _assert_audio_close(got, ref)


def test_synthesis_with_a_root_key_matches_jax():
    """key=prng_key(7) in the port against key=PRNGKey(7) in JAX; the same
    key passed by position (the JAX position, after pf_type) binds the
    same parameter."""
    utts = _utts(3, 64, 20, 10, seed=1)
    ref = jbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=512, pf_type="magphase",
        key=jax.random.PRNGKey(7))
    got = tbatch.synthesis_from_compressed_batch(
        utts, FS, fft_len=512, pf_type="magphase", key=K.prng_key(7),
        device="cpu")
    _assert_audio_close(got, ref)
    positional = tbatch.synthesis_from_compressed_batch(
        utts, FS, 512, True, "magphase", None, True, "magphase",
        K.prng_key(7), device="cpu")
    for a, b in zip(positional, got):
        np.testing.assert_array_equal(a, b)


def test_keys_override_key():
    """Explicit keys= win over key=: the output is that of keys= alone."""
    utts = _utts(2, 32, 20, 10, seed=2)
    keys = K.split(K.prng_key(5), 2)
    kw = dict(fft_len=512, device="cpu")
    both = tbatch.synthesis_from_compressed_batch(utts, FS, key=K.prng_key(9),
                                                  keys=keys, **kw)
    alone = tbatch.synthesis_from_compressed_batch(utts, FS, keys=keys, **kw)
    for a, b in zip(both, alone):
        np.testing.assert_array_equal(a, b)


def test_key_derivation_survives_the_budget_split(monkeypatch):
    """With key= alone, a request split into groups under the frame budget
    gives each utterance the audio it has in one group (the derivation is
    prefix-stable and done once, before the split).  Bound 1e-7 of the
    peak, as test_torch_slice.py::test_budget_split_matches_one_group:
    only the row count of the batched FFTs and matmuls changes."""
    utts = _utts(5, 40, 20, 10, seed=3)
    kw = dict(fft_len=512, key=K.prng_key(4), det_fft_syn=True, device="cpu")
    whole = tbatch.synthesis_from_compressed_batch(utts, FS, **kw)
    monkeypatch.setattr(tbatch, "MAX_FRAME_ELEMS", 2 * 128 * 512)
    split = tbatch.synthesis_from_compressed_batch(utts, FS, **kw)
    peak = max(np.abs(w).max() for w in whole)
    for w, s in zip(whole, split):
        np.testing.assert_allclose(s, w, rtol=0, atol=1e-7 * peak)


def test_synthesis_signature_matches_jax():
    """The port's positional parameters up to mesh have the JAX names in
    the JAX order, with the same defaults."""
    ref = inspect.signature(jbatch.synthesis_from_compressed_batch)
    got = inspect.signature(tbatch.synthesis_from_compressed_batch)
    names_ref = list(ref.parameters)
    cut = names_ref.index("mesh") + 1
    names_got = [n for n, p in got.parameters.items()
                 if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert names_got[:cut] == names_ref[:cut]
    for n in names_ref[:cut]:
        assert got.parameters[n].default == ref.parameters[n].default, n


def _public_names(module):
    """A JAX package module's exports: its __all__, else the non-module,
    non-underscore names its __init__ binds."""
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("pair", [
    (magphase_tpu, magphase_tpu_torch),
    (magphase_tpu.epochs, magphase_tpu_torch.epochs),
    (magphase_tpu.io, magphase_tpu_torch.io),
    (magphase_tpu.vocoder, magphase_tpu_torch.vocoder),
    (magphase_tpu.ops, magphase_tpu_torch.ops),
    (magphase_tpu.parallel, magphase_tpu_torch.parallel),
    (magphase_tpu.utils, magphase_tpu_torch.utils)],
    ids=["top", "epochs", "io", "vocoder", "ops", "parallel", "utils"])
def test_port_exports_hold_the_jax_exports(pair):
    jmod, tmod = pair
    want = _public_names(jmod)
    assert want <= set(tmod.__all__) | {"__version__"}
    for name in tmod.__all__:
        obj = getattr(tmod, name)
        assert callable(obj) or inspect.ismodule(obj) or \
            name.startswith("DEFAULT") or \
            (name in ("SIG_STEP", "FRM_STEP") and isinstance(obj, int))


def test_top_level_exports_the_vocoder():
    """The package's top level exports every name of the JAX package's
    vocoder/__init__.py:__all__, each the port's vocoder object."""
    import magphase_tpu.vocoder as jvoc
    for name in jvoc.__all__:
        assert name in magphase_tpu_torch.__all__, name
        assert getattr(magphase_tpu_torch, name) is getattr(
            magphase_tpu_torch.vocoder, name)


def test_get_pitch_marks_is_extract_epochs_times():
    """get_pitch_marks returns extract_epochs' mark times (seconds)."""
    from magphase_tpu.utils.tracker_eval import make_stimulus
    sig = make_stimulus(16000, [(0.3, 120, 180)], seed=5)[0]
    got = magphase_tpu_torch.epochs.get_pitch_marks(sig, 16000, device="cpu")
    ref = magphase_tpu_torch.epochs.extract_epochs(sig, 16000,
                                                   device="cpu")[0]
    np.testing.assert_array_equal(got, ref)
    assert len(got) > 10 and np.all(np.diff(got) > 0)


def test_import_builds_no_kernel():
    """Importing the package, its entries, its kernel modules, the CLI, the
    daemon and the native I/O binding in a fresh interpreter loads no
    kernel or native library, writes nothing to the build directories and
    imports no jax: each _library() and the native _load() stay lazy."""
    code = (
        "import sys\n"
        "import magphase_tpu_torch, magphase_tpu_torch.epochs\n"
        "import magphase_tpu_torch.parallel, magphase_tpu_torch.ops\n"
        "import magphase_tpu_torch.vocoder.variants\n"
        "import magphase_tpu_torch.cli, magphase_tpu_torch.serve\n"
        "from magphase_tpu_torch.io import native\n"
        "from magphase_tpu_torch.kernels import dft, framing, walk\n"
        "assert 'jax' not in sys.modules\n"
        "assert native._load.cache_info().currsize == 0\n"
        "for m in (dft, framing, walk):\n"
        "    assert m._library.cache_info().currsize == 0, m.__name__\n")

    from magphase_tpu_torch.io import native

    def listing():
        return [sorted(p.name for p in d.iterdir()) if d.exists() else None
                for d in (_build.BUILD_DIR, native.BUILD_DIR)]

    before = listing()
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])
    assert listing() == before
