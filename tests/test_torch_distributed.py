"""Multi-process corpus runs of the port: two worker processes meet in a
torch.distributed gloo group over localhost (once by torchrun's variables,
once by the JAX CLI's), split the tokens (round-robin, LPT by the agreed
weights, round-robin again when the weights disagree), name distinct
manifests and sum their metrics; a mistyped coordinator raises; and a
two-process `cli extract` + `cli generate` merges byte-identical to one
process (the CPU twin of tests/test_multihost_corpus.py)."""
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from magphase_tpu_torch.cli import main as port_cli
from magphase_tpu_torch.io import write_wav
from magphase_tpu_torch.parallel.mesh import partition_tokens
from magphase_tpu_torch.utils.tracker_eval import make_stimulus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = [f"utt{i:02d}" for i in range(7)]
WEIGHTS = [1.0, 5.0, 2.0, 4.0, 3.0, 6.0, 0.5]

_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["MAGPHASE_REPO"])
from magphase_tpu_torch import cli
from magphase_tpu_torch.parallel import mesh
from magphase_tpu_torch.utils.metrics import Metrics

cli._distributed_setup()
r, n = mesh.rank(), mesh.world_size()
toks = json.loads(os.environ["MAGPHASE_TOKENS"])
weights = json.loads(os.environ["MAGPHASE_WEIGHTS"])
rr, manifest = cli._host_partition(toks)
lpt, _ = cli._host_partition(toks, lambda: weights)
# one process reads other sizes, one cannot read them: both fall back
differ, _ = cli._host_partition(toks, lambda: [w + r for w in weights])
fails, _ = cli._host_partition(
    toks, (lambda: [][0]) if r == 1 else (lambda: weights))
m = Metrics()
m.add_audio(1.5 * (r + 1))
total = m.reduce_across_hosts().audio_seconds
json.dump(dict(rank=r, size=n, rr=rr, lpt=lpt, differ=differ, fails=fails,
               manifest=manifest, total=total),
          open(os.environ["MAGPHASE_OUT"], "w"))
"""


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                        "JAX_PROCESS_ID", "WORLD_SIZE", "RANK",
                        "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    env.update(MAGPHASE_REPO=REPO, OMP_NUM_THREADS="2", **extra)
    return env


def _group_env(style, port, rank):
    if style == "torchrun":
        return dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                    WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                    LOCAL_WORLD_SIZE="2")
    return dict(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank))


def _run_two(cmd, extra_of_rank, timeout=240):
    procs = [subprocess.Popen(cmd, env=_env(extra_of_rank(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, err[-4000:]


@pytest.mark.parametrize("style", ["torchrun", "jax"])
def test_two_process_group(tmp_path, style):
    port = _port()
    outs = [tmp_path / f"w{r}.json" for r in range(2)]
    _run_two([sys.executable, "-c", _WORKER], lambda r: dict(
        _group_env(style, port, r), MAGPHASE_OUT=str(outs[r]),
        MAGPHASE_TOKENS=json.dumps(TOKENS),
        MAGPHASE_WEIGHTS=json.dumps(WEIGHTS)))
    res = [json.load(open(o)) for o in outs]
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["size"] == 2 for r in res)
    for key in ("rr", "lpt", "differ", "fails"):
        a, b = (set(r[key]) for r in res)
        assert a.isdisjoint(b) and a | b == set(TOKENS), key
    for r in res:
        i = r["rank"]
        assert r["rr"] == r["differ"] == r["fails"] == TOKENS[i::2]
        assert r["lpt"] == partition_tokens(TOKENS, i, 2, WEIGHTS)
        assert r["manifest"] == f".magphase_manifest.p{i}.json"
        assert r["total"] == 1.5 + 3.0
    assert res[0]["lpt"] != res[0]["rr"]


def test_bad_coordinator_raises(tmp_path):
    """A coordinator address that does not parse raises in every process
    instead of letting each run the whole corpus."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from magphase_tpu_torch import cli\n"
            "cli._distributed_setup()\n") % REPO
    p = subprocess.run([sys.executable, "-c", code], env=_env(dict(
        JAX_COORDINATOR_ADDRESS="127.0.0.1:notaport", JAX_NUM_PROCESSES="2",
        JAX_PROCESS_ID="0")), capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "notaport" in p.stderr
    p = subprocess.run([sys.executable, "-c", code], env=_env(dict(
        JAX_COORDINATOR_ADDRESS="127.0.0.1:1234")), capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and "JAX_NUM_PROCESSES" in p.stderr


def _corpus(root, fs=16000):
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    segs = [[(0.3, 120, 150)], [(0.1, None, None), (0.3, 180, 140)],
            [(0.35, 95, 110)], [(0.25, 220, 200), (0.05, None, None)]]
    toks = [f"s{i}" for i in range(4)]
    for tok, seg in zip(toks, segs):
        write_wav(str(wav_dir / f"{tok}.wav"),
                  make_stimulus(fs, seg, seed=len(tok) + int(tok[1]))[0], fs)
    scp = root / "file_id.scp"
    scp.write_text("\n".join(toks) + "\n")
    return toks, str(wav_dir), str(scp)


def _cli_args(scp, wav_dir, out):
    return (["extract", "--scp", scp, "--wav-dir", wav_dir, "--out-dir",
             str(out / "feats"), "--batch-size", "2", "--fft-len", "512",
             "--device", "cpu"],
            ["generate", "--scp", scp, "--feats-dir", str(out / "feats"),
             "--out-dir", str(out / "wavs"), "--fs", "16000",
             "--batch-size", "2", "--pf-type", "no", "--device", "cpu"])


def _tree(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(d))
            if not f.startswith(".")}


def test_two_process_corpus_merge_is_byte_identical(tmp_path):
    toks, wav_dir, scp = _corpus(tmp_path)
    for args in _cli_args(scp, wav_dir, tmp_path / "one"):
        assert port_cli(args) == 0
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from magphase_tpu_torch.cli import main\n"
            "sys.exit(main(json.loads(sys.argv[1])))\n") % REPO
    for args in _cli_args(scp, wav_dir, tmp_path / "two"):
        port = _port()
        _run_two([sys.executable, "-c", code, json.dumps(args)],
                 lambda r: _group_env("jax", port, r))
    for sub in ("feats", "wavs"):
        d = tmp_path / "two" / sub
        shards = [set(json.load(open(d / f".magphase_manifest.p{r}.json"))
                      ["done"]) for r in range(2)]
        assert shards[0].isdisjoint(shards[1])
        assert shards[0] | shards[1] == set(toks)
        one = _tree(tmp_path / "one" / sub)
        assert len(one) == (5 if sub == "feats" else 1) * len(toks)
        assert _tree(d) == one
    sig = np.frombuffer(open(tmp_path / "two" / "wavs" / "s0.wav", "rb")
                        .read()[44:], "<i2")
    assert np.std(sig) > 10
