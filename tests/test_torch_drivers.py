"""The port's host-side corpus code against the JAX package's:
run_staged (the cases of tests/test_pipeline.py), run_corpus /
run_corpus_batched (those
of tests/test_corpus_batched.py) and the manifest, the scp and label
utilities, write_wav_pcm16, the native corpus-IO binding against the
Python codec (tests/test_native_io.py), metrics, and utils/eval.py.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from magphase_tpu.io import labels as jlabels
from magphase_tpu.io import scp as jscp
from magphase_tpu.io import wav as jwav
from magphase_tpu.utils import corpus as jcorpus
from magphase_tpu.utils import eval as jeval
from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu_torch.io import labels as tlabels
from magphase_tpu_torch.io import native
from magphase_tpu_torch.io import scp as tscp
from magphase_tpu_torch.io import wav as twav
from magphase_tpu_torch.io.featfile import write_binfile
from magphase_tpu_torch.utils import eval as teval
from magphase_tpu_torch.utils import metrics as tmetrics
from magphase_tpu_torch.utils.corpus import (Manifest, run_corpus,
                                             run_corpus_batched)
from magphase_tpu_torch.utils.pipeline import run_staged

FS = 48000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# run_staged

@pytest.mark.parametrize("depth", [1, 2, 4])
def test_run_staged_order_and_results(depth):
    out = list(run_staged(range(20), [lambda x: x + 1,
                                      lambda x: x * 2,
                                      lambda x: x - 3], depth=depth))
    assert out == [(x + 1) * 2 - 3 for x in range(20)]


def test_run_staged_stages_overlap_in_time():
    """Three 30 ms stages over 6 items: serial = 540 ms, pipelined
    ~= 240 ms.  Gate at < 450 ms (loose for CI noise)."""
    def slow(x):
        time.sleep(0.03)
        return x

    t0 = time.perf_counter()
    out = list(run_staged(range(6), [slow, slow, slow]))
    dt = time.perf_counter() - t0
    assert out == list(range(6))
    assert dt < 0.45, dt


def test_run_staged_exception_propagates_and_threads_end():
    def boom(x):
        if x == 3:
            raise ValueError("boom")
        return x

    pipe = run_staged(range(10), [lambda x: x, boom, lambda x: x])
    with pytest.raises(ValueError, match="boom"):
        list(pipe)
    for t in pipe._threads:
        t.join(timeout=5.0)
        assert not t.is_alive()


def test_run_staged_early_abandon_does_not_hang():
    pipe = run_staged(range(100), [lambda x: x, lambda x: x])
    it = iter(pipe)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    pipe.close()
    assert not any(t.is_alive() for t in pipe._threads)


def test_run_staged_eager_start():
    """Work begins at construction, before the caller pulls results."""
    seen = []
    pipe = run_staged(range(4), [lambda x: seen.append(x) or x])
    deadline = time.time() + 2.0
    while not seen and time.time() < deadline:
        time.sleep(0.01)
    assert seen, "stage did not start before iteration"
    assert list(pipe) == [0, 1, 2, 3]


def test_run_staged_empty_stages_and_items():
    assert list(run_staged([1, 2], [])) == [1, 2]
    assert list(run_staged([], [lambda x: x])) == []


def test_run_staged_reiteration_raises():
    pipe = run_staged(range(5), [lambda x: x])
    assert list(pipe) == list(range(5))
    with pytest.raises(RuntimeError, match="single-shot"):
        list(pipe)


def test_run_staged_feeder_exception_propagates():
    """An item source that raises tears the pipeline down too."""
    def items():
        yield 1
        raise KeyError("source")

    with pytest.raises(KeyError):
        list(run_staged(items(), [lambda x: x]))


# ---------------------------------------------------------------------------
# the corpus runners and the manifest

def test_batched_isolation_and_resume(tmp_path):
    out = str(tmp_path / "feats")
    crash = str(tmp_path / "crash.scp")
    tokens = [f"utt_{i:02d}" for i in range(10)]
    calls = []

    def process_batch(chunk):
        calls.append(tuple(chunk))
        if "utt_04" in chunk:
            raise RuntimeError("bad wav")
        return [1.0] * len(chunk)

    res = run_corpus_batched(tokens, process_batch, out, batch_size=4,
                             crash_list_path=crash)
    assert res.failed == ["utt_04"]
    assert sorted(res.done) == sorted(t for t in tokens if t != "utt_04")
    with open(crash) as f:
        assert f.read().split() == ["utt_04"]
    assert ("utt_04",) in calls

    calls.clear()

    def process_batch_ok(chunk):
        calls.append(tuple(chunk))
        return [1.0] * len(chunk)

    res2 = run_corpus_batched(tokens, process_batch_ok, out, batch_size=4,
                              crash_list_path=crash)
    assert res2.done == ["utt_04"]
    assert len(res2.skipped) == 9
    assert calls == [("utt_04",)]


def test_batched_deferred_pipeline(tmp_path):
    """process_batch_fn returning finalize() callables: chunks overlap,
    failures inside finalize still isolate to the bad utterance."""
    out = str(tmp_path / "feats")
    tokens = [f"utt_{i:02d}" for i in range(12)]
    events = []

    def process_batch(chunk):
        events.append(("dispatch", tuple(chunk)))

        def finalize():
            events.append(("finalize", tuple(chunk)))
            if "utt_06" in chunk and len(chunk) > 1:
                raise RuntimeError("bad utterance in finalize")
            return [1.0] * len(chunk)

        return finalize

    res = run_corpus_batched(tokens, process_batch, out, batch_size=4,
                             pipeline_depth=2)
    assert sorted(res.done) == tokens
    assert res.failed == []
    d1 = events.index(("dispatch", tuple(tokens[4:8])))
    f0 = events.index(("finalize", tuple(tokens[0:4])))
    assert d1 < f0


def test_run_corpus_isolation_audio_and_config_restart(tmp_path):
    """Per-utterance isolation and audio seconds; a manifest written under
    another config restarts the corpus instead of skipping."""
    out = str(tmp_path / "o")
    crash = str(tmp_path / "crash.scp")

    def proc(tok):
        if tok == "b":
            raise ValueError("bad")
        return 1.5

    res = run_corpus(["a", "b", "c"], proc, out, config={"k": 1},
                     crash_list_path=crash)
    assert res.done == ["a", "c"] and res.failed == ["b"]
    assert res.metrics.audio_seconds == 3.0
    assert open(crash).read().split() == ["b"]
    again = run_corpus(["a", "b", "c"], lambda t: 1.0, out, config={"k": 1})
    assert again.skipped == ["a", "c"] and again.done == ["b"]
    other = run_corpus(["a", "b", "c"], lambda t: 1.0, out, config={"k": 2})
    assert other.done == ["a", "b", "c"]


def test_manifest_reads_and_writes_the_jax_json(tmp_path):
    """One corpus directory, either package's manifest: the same file,
    and each reads what the other wrote."""
    cfg = {"fs": 48000, "mag_dim": 60, "transport": "int8"}
    for writer, reader in ((Manifest, jcorpus.Manifest),
                           (jcorpus.Manifest, Manifest)):
        d = tmp_path / writer.__module__
        d.mkdir()
        m = writer(str(d), cfg)
        for t in ("z", "a", "m"):
            m.mark(t)
        m.save()
        assert reader(str(d), cfg).done == {"a", "m", "z"}
        assert reader(str(d), {"fs": 16000}).done == set()
    a = (tmp_path / Manifest.__module__ / ".magphase_manifest.json")
    b = (tmp_path / jcorpus.Manifest.__module__ / ".magphase_manifest.json")
    assert a.read_bytes() == b.read_bytes()
    assert json.loads(a.read_text())["done"] == ["a", "m", "z"]


def test_metrics_summary_and_profile_noop():
    m = tmetrics.Metrics()
    with m.stage("process"):
        pass
    m.add_audio(2.0)
    s = m.summary()
    assert s["audio_seconds"] == 2.0 and s["stages"]["process"]["n"] == 1
    assert m.reduce_across_hosts() is m
    with tmetrics.profile_trace(None):
        pass
    tmetrics.setup_logging()
    assert tmetrics.logger.name == "magphase_tpu_torch"


# ---------------------------------------------------------------------------
# scp, labels, wav

def test_scp_utilities_match_jax(tmp_path):
    p = tmp_path / "x.scp"
    p.write_text("a  # one\n\n  b\n#c\nd#e\n")
    assert tscp.read_scp_file(str(p)) == jscp.read_scp_file(str(p)) == \
        ["a", "b", "d"]
    assert tscp.gen_list_of_file_paths("/d", ["a", "b"], ".wav") == \
        jscp.gen_list_of_file_paths("/d", ["a", "b"], ".wav")
    assert tscp.get_filename("/x/y/tok.lab") == "tok"
    tscp.mkdir([str(tmp_path / "m1"), str(tmp_path / "m2")])
    tscp.mkdir(str(tmp_path / "m1"))
    assert tscp.get_file_list(str(tmp_path / "m*")) [1] == 2


@pytest.fixture(scope="module")
def lab_case(tmp_path_factory):
    """A .shift track (variable shifts) and HTS labels over its span: 6
    phones of 5 states, with one state that holds no epoch."""
    d = tmp_path_factory.mktemp("labs")
    rng = np.random.default_rng(3)
    shifts = rng.integers(160, 400, 200).astype(np.float32)
    write_binfile(shifts, str(d / "u.shift"))
    end = int(np.ceil((np.cumsum(shifts)[-1] * 1000.0 / FS + 1.0) * 1e4))
    cuts = list(np.linspace(0, end, 31).astype(np.int64))
    cuts[7] = cuts[6] + 1            # a state too short for any epoch
    with open(d / "u.lab", "w") as f:
        for i in range(30):
            f.write(f"{cuts[i]} {cuts[i + 1]} x^a-b+c=d@{i // 5}"
                    f"[{i % 5 + 2}]\n")
    return d


def test_labels_match_jax(lab_case, tmp_path):
    sh = str(lab_case / "u.shift")
    lab = str(lab_case / "u.lab")
    v_shift = np.fromfile(sh, np.float32).astype(np.float64)
    for kw in (dict(), dict(b_prevent_zeros=True)):
        got = tlabels.get_num_of_frms_per_state(v_shift, lab, FS, **kw)
        ref = jlabels.get_num_of_frms_per_state(v_shift, lab, FS, **kw)
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tlabels.get_num_of_frms_per_phon_unit(v_shift, lab, FS),
        jlabels.get_num_of_frms_per_phon_unit(v_shift, lab, FS))
    for refine in (False, True):
        np.testing.assert_array_equal(
            tlabels.frame_to_state_mapping(sh, lab, FS, b_refine=refine),
            jlabels.frame_to_state_mapping(sh, lab, FS, b_refine=refine))
    nf = tlabels.get_num_of_frms_per_state(v_shift, lab, FS,
                                           b_prevent_zeros=True)
    tlabels.convert_label_state_align_to_var_frame_rate(
        lab, nf, str(tmp_path / "t.lab"))
    jlabels.convert_label_state_align_to_var_frame_rate(
        lab, nf, str(tmp_path / "j.lab"))
    assert (tmp_path / "t.lab").read_bytes() == \
        (tmp_path / "j.lab").read_bytes()
    with pytest.raises(ValueError):
        tlabels.get_num_of_frms_per_state(v_shift[:100], lab, FS)


def test_write_wav_pcm16_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    pcm = rng.integers(-32768, 32768, 4001).astype(np.int16)
    twav.write_wav_pcm16(str(tmp_path / "t.wav"), pcm, 22050)
    jwav.write_wav_pcm16(str(tmp_path / "j.wav"), pcm, 22050)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    sig, fs = twav.read_wav(str(tmp_path / "t.wav"))
    assert fs == 22050
    np.testing.assert_array_equal(sig * 32768.0, pcm)


# ---------------------------------------------------------------------------
# native corpus IO

@pytest.fixture(scope="module")
def wav_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("nat")
    paths = []
    for i, secs in enumerate((0.3, 0.5, 0.4)):
        sig = make_stimulus(FS, [(secs, 120 + 30 * i, 150)], seed=i)[0]
        paths.append(str(d / f"w{i}.wav"))
        twav.write_wav(paths[-1], 0.5 * sig / np.abs(sig).max(), FS)
    return paths


@pytest.fixture(scope="module")
def lib_ok():
    if not native.build():
        pytest.skip("no C++ compiler: the Python codec stands in")
    return True


def test_native_builds_outside_the_source_dir(lib_ok):
    """The library is built from native/magphase_io.cpp into
    build/native_io/, never into native/."""
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.SOURCE.parent != path.parent
    assert native.available()


def test_native_read_wav_matches_python(lib_ok, wav_paths):
    for p in wav_paths:
        sig_py, fs_py = twav.read_wav(p)
        sig_na, fs_na = native.read_wav(p)
        assert fs_na == fs_py and sig_na.dtype == np.float32
        np.testing.assert_array_equal(sig_na, sig_py.astype(np.float32))


def test_native_batch_read_matches_python(lib_ok, wav_paths):
    max_len = 1 << 15
    out, lens, fss = native.batch_read_wavs(wav_paths, max_len)
    assert out.shape == (len(wav_paths), max_len)
    for i, p in enumerate(wav_paths):
        sig, fs = twav.read_wav(p)
        assert fss[i] == fs and lens[i] == len(sig)
        np.testing.assert_array_equal(out[i, :lens[i]],
                                      sig.astype(np.float32))
        assert np.all(out[i, lens[i]:] == 0.0)


def test_native_binfile_and_wav_write(lib_ok, tmp_path):
    m = np.random.RandomState(0).randn(40, 60).astype(np.float32)
    p = str(tmp_path / "x.mag")
    write_binfile(m, p)
    np.testing.assert_array_equal(native.read_binfile(p, dim=60), m)
    with pytest.raises(ValueError):
        native.read_binfile(p, dim=7)
    sig = np.linspace(-0.9, 0.9, 1001)
    native.write_wav(str(tmp_path / "n.wav"), sig, FS)
    twav.write_wav(str(tmp_path / "p.wav"), sig, FS)
    a, fa = twav.read_wav(str(tmp_path / "n.wav"))
    b, fb = twav.read_wav(str(tmp_path / "p.wav"))
    assert fa == fb == FS
    assert np.max(np.abs(a - b)) * 32768.0 <= 1.0


def test_python_codec_stands_in_without_the_library(monkeypatch,
                                                    wav_paths):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    out, lens, fss = native.batch_read_wavs(wav_paths, 1 << 15)
    for i, p in enumerate(wav_paths):
        sig, fs = twav.read_wav(p)
        np.testing.assert_array_equal(out[i, :lens[i]],
                                      sig.astype(np.float32))
    sig, fs = native.read_wav(wav_paths[0])
    assert sig.dtype == np.float32 and fs == FS


# ---------------------------------------------------------------------------
# eval

@pytest.fixture(scope="module")
def eval_pair():
    sig = make_stimulus(FS, [(0.2, None, None), (0.8, 110, 180),
                             (0.2, None, None)], seed=2)[0]
    n = len(sig)
    drift = np.concatenate([np.full(n // 3, 0), np.full(n // 3, 20),
                            np.full(n - 2 * (n // 3), -15)])
    warped = sig[np.clip(np.arange(n) + drift, 0, n - 1)] * 0.8
    return sig, warped


def test_eval_matches_jax(eval_pair):
    """numpy float64 in both packages: equal to round-off."""
    a, b = eval_pair
    np.testing.assert_allclose(teval.log_mel_spectrogram(a, FS),
                               jeval.log_mel_spectrogram(a, FS),
                               rtol=1e-12, atol=1e-12)
    for x, y in zip(teval.align_by_xcorr(a, b, FS),
                    jeval.align_by_xcorr(a, b, FS)):
        np.testing.assert_array_equal(x, y)
    for kw in (dict(), dict(exclude_gain=True), dict(floor_db=60.0),
               dict(align=False)):
        assert teval.mel_spectral_distortion(a, b, FS, **kw) == \
            pytest.approx(jeval.mel_spectral_distortion(a, b, FS, **kw),
                          rel=1e-12)
    got = teval.mel_spectral_distortion_piecewise(a, b, FS,
                                                  return_worst=True)
    ref = jeval.mel_spectral_distortion_piecewise(a, b, FS,
                                                  return_worst=True)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    m = teval.log_mel_spectrogram(a, FS)
    assert teval.log_spectral_distortion_feats(m, m + 0.1) == \
        pytest.approx(jeval.log_spectral_distortion_feats(m, m + 0.1),
                      rel=1e-12)
    assert teval.mel_spectral_distortion(a, a, FS) == 0.0


def test_corpus_modules_import_no_jax():
    """The port's corpus modules, imported in a fresh interpreter, pull in
    neither jax nor the JAX package."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import magphase_tpu_torch.cli, magphase_tpu_torch.serve\n"
            "import magphase_tpu_torch.io.native, magphase_tpu_torch.io.labels\n"
            "import magphase_tpu_torch.utils.eval\n"
            "import magphase_tpu_torch.utils.corpus\n"
            "import magphase_tpu_torch.utils.transfer\n"
            "import magphase_tpu_torch.parallel.mesh\n"
            "bad = [m for m in sys.modules\n"
            "       if m == 'jax' or m.startswith(('jax.', 'magphase_tpu.'))\n"
            "       or m == 'magphase_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
