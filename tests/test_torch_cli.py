"""The port's CLI (``--device cpu``) against the JAX CLI (CPU backend) on
one synthetic corpus: extract at batch sizes 2 and 1, generate (f16 and
int8 transports) from the same JAX-extracted features, convert-labels,
eval; crash-list isolation of a bad wav and of an unreadable feature
file; the pipelined runner against the fallback runner; manifest resume
across the two CLIs; and the port CLI's device and multi-device guards.

The corpus: 3 utterances of about 1.5 s of make_stimulus speech at
48 kHz, of different lengths, written as PCM16 wavs, with HTS
state-aligned labels built over each one's span.  The JAX CLI runs once,
in the module-scoped ``jax_runs`` fixture.
"""
import contextlib
import hashlib
import io
import json
import os
import shutil
import wave

import numpy as np
import pytest
import torch

from magphase_tpu.cli import main as jax_cli
from magphase_tpu.io import wav as jwav
from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu_torch import cli as tcli
from magphase_tpu_torch.cli import main as port_cli
from magphase_tpu_torch.io import read_binfile
from magphase_tpu_torch.parallel import batch as tbatch

FS = 48000
TOKS = ["utt0", "utt1", "utt2"]
SEGMENTS = [
    [(0.2, None, None), (0.5, 120, 160), (0.1, None, None),
     (0.6, 180, 110), (0.1, None, None)],
    [(0.1, None, None), (0.7, 200, 240), (0.2, None, None),
     (0.5, 100, 90)],
    [(0.3, 90, 150), (0.15, None, None), (0.9, 140, 200),
     (0.1, None, None)]]
DIMS = {".mag": 60, ".real": 45, ".imag": 45, ".lf0": 1, ".shift": 1}
# the mel streams, port against the JAX entry (tests/test_torch_analysis.py
# TOL_VS_JAX_ENTRY: the JAX compressed analysis takes a matmul DFT at
# relative error ~1e-5); the batch path writes them rounded through float16,
# which adds at most one float16 step of the value
TOL_MEL = 5e-4
TOL_LF0_REL = 1e-6
CPU = ["--device", "cpu"]


def _write_labels(shift_path, lab_path, n_phones=6):
    """HTS state-aligned labels (5 states a phone, 100 ns units) spanning
    the epochs of a .shift track in equal states."""
    ep_ms = np.cumsum(np.fromfile(shift_path, np.float32)) * 1000.0 / FS
    end = int(np.ceil((ep_ms[-1] + 1.0) * 1e4))
    cuts = np.linspace(0, end, 5 * n_phones + 1).astype(np.int64)
    with open(lab_path, "w") as f:
        for i in range(5 * n_phones):
            f.write(f"{cuts[i]} {cuts[i + 1]} ph{i // 5}[{i % 5 + 2}]\n")


def _run(cli, argv):
    """rc and stdout of one CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    (d / "wavs").mkdir()
    for i, segs in enumerate(SEGMENTS):
        sig = make_stimulus(FS, segs, seed=i)[0]
        jwav.write_wav(str(d / "wavs" / f"{TOKS[i]}.wav"),
                       0.5 * sig / np.abs(sig).max(), FS)
    (d / "all.scp").write_text("\n".join(TOKS) + "\n")
    return d


@pytest.fixture(scope="module")
def jax_runs(corpus):
    """Every JAX CLI run the tests compare with, once."""
    d = corpus
    scp, wavs = str(d / "all.scp"), str(d / "wavs")
    runs = {}
    for name, bs in (("feats", "2"), ("feats1", "1")):
        runs[name] = _run(jax_cli, ["extract", "--scp", scp, "--wav-dir",
                                    wavs, "--out-dir", str(d / f"j_{name}"),
                                    "--batch-size", bs])[0]
    (d / "labs").mkdir()
    for t in TOKS:
        _write_labels(d / "j_feats" / f"{t}.shift", d / "labs" / f"{t}.lab")
    for tr in ("f16", "int8"):
        runs[f"wav_{tr}"] = _run(jax_cli, [
            "generate", "--scp", scp, "--feats-dir", str(d / "j_feats"),
            "--out-dir", str(d / f"j_wav_{tr}"), "--batch-size", "2",
            "--transport", tr])[0]
    runs["labs"] = _run(jax_cli, [
        "convert-labels", "--scp", scp, "--shift-dir", str(d / "j_feats"),
        "--lab-dir", str(d / "labs"), "--out-dir", str(d / "j_labs")])[0]
    for mode, ref, cand in (("wav", "wavs", "j_wav_f16"),
                            ("feats", "j_feats", "j_feats1")):
        runs[f"eval_{mode}"] = _run(jax_cli, [
            "eval", "--scp", scp, "--ref-dir", str(d / ref), "--cand-dir",
            str(d / cand), "--mode", mode])
    assert all((v if isinstance(v, int) else v[0]) == 0
               for v in runs.values()), runs
    return runs


def _pcm(path):
    with wave.open(str(path)) as w:
        assert w.getframerate() == FS
        return np.frombuffer(w.readframes(w.getnframes()),
                             np.int16).astype(np.int32)


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.mark.parametrize("bs", ["2", "1"])
def test_extract_matches_jax(corpus, jax_runs, tmp_path, bs):
    """Feature files of both CLIs: the same files, the same shapes, .shift
    equal, lf0 within 1e-6 relative, the mel streams within TOL_MEL (plus
    one float16 step where the batch path rounds them)."""
    ref_dir = corpus / ("j_feats" if bs == "2" else "j_feats1")
    out = tmp_path / "feats"
    assert port_cli(["extract", "--scp", str(corpus / "all.scp"),
                     "--wav-dir", str(corpus / "wavs"), "--out-dir",
                     str(out), "--batch-size", bs] + CPU) == 0
    assert sorted(p for p in os.listdir(out) if not p.startswith(".")) == \
        sorted(p for p in os.listdir(ref_dir) if not p.startswith("."))
    for t in TOKS:
        for ext, dim in DIMS.items():
            got = read_binfile(str(out / (t + ext)), dim)
            ref = read_binfile(str(ref_dir / (t + ext)), dim)
            assert got.shape == ref.shape, (t, ext)
            if ext == ".shift":
                np.testing.assert_array_equal(got, ref)
            elif ext == ".lf0":
                np.testing.assert_allclose(got, ref, rtol=TOL_LF0_REL,
                                           atol=0)
            else:
                step = 0.0
                if bs == "2":
                    step = np.spacing(np.abs(ref).astype(np.float16)
                                      ).astype(np.float64)
                assert np.all(np.abs(got - ref) <= TOL_MEL + step), (t, ext)


@pytest.mark.parametrize("transport", ["f16", "int8"])
def test_generate_matches_jax(corpus, jax_runs, tmp_path, transport):
    """Waveforms from the same (JAX-extracted) features: the same lengths,
    PCM16 samples within one step (float32 round-off in another order can
    flip a rounding boundary), with the same noise keys by scp index."""
    out = tmp_path / "wavs"
    assert port_cli(["generate", "--scp", str(corpus / "all.scp"),
                     "--feats-dir", str(corpus / "j_feats"), "--out-dir",
                     str(out), "--batch-size", "2", "--transport",
                     transport] + CPU) == 0
    for t in TOKS:
        a = _pcm(out / f"{t}.wav")
        b = _pcm(corpus / f"j_wav_{transport}" / f"{t}.wav")
        assert a.shape == b.shape, t
        d = np.abs(a - b)
        assert d.max() <= 1, (t, d.max())
        assert np.mean(d > 0) < 0.01, (t, float(np.mean(d > 0)))


def test_convert_labels_byte_identical(corpus, jax_runs, tmp_path):
    out = tmp_path / "labs"
    assert port_cli(["convert-labels", "--scp", str(corpus / "all.scp"),
                     "--shift-dir", str(corpus / "j_feats"), "--lab-dir",
                     str(corpus / "labs"), "--out-dir", str(out)]) == 0
    for t in TOKS:
        assert (out / f"{t}.lab").read_bytes() == \
            (corpus / "j_labs" / f"{t}.lab").read_bytes(), t


@pytest.mark.parametrize("mode", ["wav", "feats"])
def test_eval_matches_jax(corpus, jax_runs, mode):
    """The same JSON (values rounded to 3 decimals by both CLIs)."""
    ref, cand = (("wavs", "j_wav_f16") if mode == "wav"
                 else ("j_feats", "j_feats1"))
    rc, out = _run(port_cli, ["eval", "--scp", str(corpus / "all.scp"),
                              "--ref-dir", str(corpus / ref), "--cand-dir",
                              str(corpus / cand), "--mode", mode])
    assert rc == 0
    got = json.loads(out.strip().splitlines()[-1])
    want = json.loads(jax_runs[f"eval_{mode}"][1].strip().splitlines()[-1])
    assert got == want
    assert want["mean_db"] > 0.0


def test_extract_bad_wav_isolated(corpus, tmp_path):
    """A corrupt wav mid-corpus: the chunk runner isolates it through
    singleton retries; its chunk-mates still extract."""
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for t in TOKS[:2]:
        shutil.copy(corpus / "wavs" / f"{t}.wav", wavs / f"{t}.wav")
    (wavs / "broken.wav").write_bytes(b"RIFFgarbage")
    scp = tmp_path / "ex.scp"
    scp.write_text(f"{TOKS[0]}\nbroken\n{TOKS[1]}\n")
    out, crash = tmp_path / "feats", tmp_path / "crash.scp"
    rc = port_cli(["extract", "--scp", str(scp), "--wav-dir", str(wavs),
                   "--out-dir", str(out), "--batch-size", "3",
                   "--crash-list", str(crash)] + CPU)
    assert rc == 1
    for t in TOKS[:2]:
        assert (out / f"{t}.mag").exists(), t
    assert not (out / "broken.mag").exists()
    assert crash.read_text().split() == ["broken"]


def _feats_with_a_bad_mag(corpus, tmp_path):
    feats = tmp_path / "feats"
    feats.mkdir()
    for t in TOKS:
        for ext in (".mag", ".real", ".imag", ".lf0"):
            shutil.copy(corpus / "j_feats" / (t + ext), feats / (t + ext))
    # a truncated .mag (not a multiple of the feature dim: read raises)
    (feats / f"{TOKS[1]}.mag").write_bytes(b"\x00" * 37)
    return feats


@pytest.mark.parametrize("bs", ["2", "3"])
def test_generate_unreadable_parks_only_failing_token(corpus, jax_runs,
                                                      tmp_path, monkeypatch,
                                                      bs):
    """An unreadable feature file parks ONLY its own token: its chunk-mates
    stay on the pipelined path (the fallback runner's batch synthesis is
    never called: the parked token fails at read time), the bad token
    lands on the crash list, rc 1."""
    feats = _feats_with_a_bad_mag(corpus, tmp_path)
    calls = []
    orig = tbatch.synthesis_from_compressed_batch

    def spy(utts, *a, **kw):
        calls.append(len(utts))
        return orig(utts, *a, **kw)

    monkeypatch.setattr(tbatch, "synthesis_from_compressed_batch", spy)
    out, crash = tmp_path / "wavs", tmp_path / "crash.scp"
    rc = port_cli(["generate", "--scp", str(corpus / "all.scp"),
                   "--feats-dir", str(feats), "--out-dir", str(out),
                   "--batch-size", bs, "--pf-type", "no",
                   "--crash-list", str(crash)] + CPU)
    assert rc == 1
    assert (out / f"{TOKS[0]}.wav").exists()
    assert (out / f"{TOKS[2]}.wav").exists()
    assert not (out / f"{TOKS[1]}.wav").exists()
    assert crash.read_text().split() == [TOKS[1]]
    assert calls == []


def test_generate_fallback_runner_byte_identical(corpus, jax_runs, tmp_path,
                                                 monkeypatch):
    """The chunk-isolating fallback runner renders byte-identical wavs to
    the pipelined path (same keys by scp index, same fixed synthesis FFT,
    same halves of a group), and the pipelined path's wavs do not depend
    on the batch size."""
    common = ["generate", "--scp", str(corpus / "all.scp"), "--feats-dir",
              str(corpus / "j_feats"), "--pf-type", "no"] + CPU
    fast, fast1 = tmp_path / "fast", tmp_path / "fast1"
    assert port_cli(common + ["--out-dir", str(fast),
                              "--batch-size", "2"]) == 0
    assert port_cli(common + ["--out-dir", str(fast1),
                              "--batch-size", "1"]) == 0
    pipelined = []

    def boom(*a, **kw):
        pipelined.append(1)
        raise RuntimeError("forced: exercise the fallback runner")
        yield  # pragma: no cover — generator shape

    monkeypatch.setattr(tbatch, "synthesis_batches_pipelined", boom)
    slow = tmp_path / "slow"
    assert port_cli(common + ["--out-dir", str(slow),
                              "--batch-size", "2"]) == 0
    assert len(pipelined) == 3          # three attempts, then the fallback
    for t in TOKS:
        assert _sha(fast / f"{t}.wav") == _sha(slow / f"{t}.wav"), t
        assert _sha(fast / f"{t}.wav") == _sha(fast1 / f"{t}.wav"), t


def test_manifest_resume_across_clis(corpus, jax_runs, tmp_path,
                                     monkeypatch):
    """The port's manifest is the JAX CLI's, JSON for JSON, and each CLI
    skips what the other finished: the port's generate into the JAX
    output dir and the JAX extract into the port's do nothing."""
    scp = str(corpus / "all.scp")
    out = tmp_path / "feats"
    extract = ["extract", "--scp", scp, "--wav-dir", str(corpus / "wavs"),
               "--out-dir", str(out), "--batch-size", "2"]
    assert port_cli(extract + CPU) == 0
    man = ".magphase_manifest.json"
    assert json.loads((out / man).read_text()) == \
        json.loads((corpus / "j_feats" / man).read_text())
    before = {p: _sha(out / p) for p in os.listdir(out)}
    assert _run(jax_cli, extract)[0] == 0
    assert {p: _sha(out / p) for p in os.listdir(out)} == before

    wav_dir = tmp_path / "wavs"
    shutil.copytree(corpus / "j_wav_f16", wav_dir)
    monkeypatch.setattr(tbatch, "synthesis_batches_pipelined", None)
    monkeypatch.setattr(tbatch, "synthesis_from_compressed_batch", None)
    assert port_cli(["generate", "--scp", scp, "--feats-dir",
                     str(corpus / "j_feats"), "--out-dir", str(wav_dir),
                     "--batch-size", "2"] + CPU) == 0


def test_cuda_device_without_cuda_raises(corpus, tmp_path, monkeypatch):
    """Without --device cpu on a machine with no CUDA device the command
    raises (it does not crash-list every utterance, nor run on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["extract", "--wav-dir", str(corpus / "wavs")],
                ["generate", "--feats-dir", str(corpus / "wavs")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli(cmd + ["--scp", str(corpus / "all.scp"), "--out-dir",
                            str(tmp_path / cmd[0])])
        assert not (tmp_path / cmd[0]).exists()


def test_data_parallel_and_multi_process_guards(monkeypatch):
    """--data-parallel builds a data mesh over this process's CUDA devices
    (none below two, off CUDA, or with one card per process under
    torchrun); under an initialised group of two processes the tokens are
    partitioned (LPT by the agreed weights) with a per-process manifest;
    a mistyped coordinator address raises instead of running the whole
    corpus in every process."""
    import torch.distributed as dist
    from magphase_tpu_torch.parallel import mesh as tmesh
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tcli._maybe_mesh(True, device=cuda) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tcli._maybe_mesh(True, device=cuda)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tcli._maybe_mesh(False, device=cuda) is None
    assert tcli._maybe_mesh(True, device=torch.device("cpu")) is None
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tcli._maybe_mesh(True, device=cuda) is None

    assert tcli._host_partition(["a", "b"]) == (
        ["a", "b"], ".magphase_manifest.json")
    monkeypatch.setattr(tmesh, "world_size", lambda: 2)
    monkeypatch.setattr(tmesh, "rank", lambda: 1)

    def all_gather(out, mine):          # both processes read the same sizes
        for t in out:
            t.copy_(mine)
    monkeypatch.setattr(dist, "all_gather", all_gather)
    toks = ["a", "b", "c", "d", "e"]
    weights = [1.0, 5.0, 2.0, 4.0, 3.0]
    got, manifest = tcli._host_partition(toks, lambda: weights)
    assert manifest == ".magphase_manifest.p1.json"
    assert got == tmesh.partition_tokens(toks, 1, 2, weights) == ["d", "e"]

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:notaport")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(ValueError):
        tcli._distributed_setup()
    assert not dist.is_initialized()


def test_server_flag_requires_socket_path():
    assert port_cli(["generate", "--server"]) == 2
