"""The port's `cli serve` daemon: two sequential generate requests through
one process (one by request(), one by `generate --server`) write the
one-shot CLI's bytes; failures come back as an rc and the daemon stays
up, also after clients that disconnect without reading; and the client
connects with a fresh socket on each retry (F5: the JAX client reuses
the socket whose connect failed, magphase_tpu/serve.py:119-133).
"""
import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from magphase_tpu_torch import serve as tserve
from magphase_tpu_torch.cli import main as port_cli
from magphase_tpu_torch.io.featfile import write_binfile
from magphase_tpu_torch.serve import request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRV = ("import sys; sys.path.insert(0, {repo!r}); "
        "from magphase_tpu_torch.cli import main; "
        "sys.exit(main(['serve', '--socket', {sock!r}]))")


def _tree_hash(d):
    h = hashlib.sha256()
    for f in sorted(os.listdir(d)):
        h.update(f.encode())
        h.update(open(os.path.join(d, f), "rb").read())
    return h.hexdigest()


@pytest.fixture(scope="module")
def feats(tmp_path_factory):
    """Compressed features of two utterances (60/45 dims, ~0.6 s) and their
    scp."""
    d = tmp_path_factory.mktemp("feats")
    rng = np.random.default_rng(0)
    for i, n in enumerate((110, 130)):
        lf0 = np.log(rng.uniform(100, 220, n))
        lf0[rng.random(n) < 0.3] = -1.0e10
        for ext, x in ((".mag", rng.standard_normal((n, 60)) * 0.3 - 3.0),
                       (".real", np.clip(rng.standard_normal((n, 45)) * 0.3,
                                         -1, 1)),
                       (".imag", np.clip(rng.standard_normal((n, 45)) * 0.3,
                                         -1, 1)),
                       (".lf0", lf0)):
            write_binfile(x, str(d / f"u{i}{ext}"))
    (d / "gen.scp").write_text("u0\nu1\n")
    return d


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("srv") / "mp.sock")
    proc = subprocess.Popen(
        [sys.executable, "-c", _SRV.format(repo=REPO, sock=sock)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    line = proc.stdout.readline()           # blocks until ready
    assert "magphase_tpu_torch serving on" in line, line
    yield sock
    try:
        assert port_cli(["serve", "--socket", sock, "--shutdown"]) == 0
    finally:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


def _gen_args(feats, out):
    return ["generate", "--scp", str(feats / "gen.scp"), "--feats-dir",
            str(feats), "--out-dir", str(out), "--pf-type", "magphase",
            "--batch-size", "2", "--device", "cpu"]


def test_serve_two_requests_byte_identical(server, feats, tmp_path):
    ref = tmp_path / "one_shot"
    assert port_cli(_gen_args(feats, ref)) == 0
    first, second = tmp_path / "srv1", tmp_path / "srv2"
    assert request(server, _gen_args(feats, first), timeout=600) == 0
    assert port_cli(_gen_args(feats, second) + ["--server", server]) == 0
    h = _tree_hash(ref)
    assert sorted(os.listdir(ref)) == [".magphase_manifest.json", "u0.wav",
                                       "u1.wav"]
    assert _tree_hash(first) == h
    assert _tree_hash(second) == h


def test_serve_relative_paths_resolve_in_the_client_cwd(server, feats,
                                                        tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = _gen_args(feats, "rel_out")
    assert request(server, args, timeout=600) == 0
    assert (tmp_path / "rel_out" / "u0.wav").exists()


def test_serve_error_reporting(server, tmp_path, capsys):
    rc = request(server, ["generate", "--scp", "/nonexistent.scp",
                          "--feats-dir", str(tmp_path), "--out-dir",
                          str(tmp_path / "x"), "--device", "cpu"],
                 timeout=120)
    assert rc != 0
    assert "FileNotFoundError" in capsys.readouterr().err
    # argparse errors come back as their exit code; the daemon lives on
    assert request(server, ["not-a-command"], timeout=120) == 2


def test_serve_survives_client_disconnects(server):
    """A client that disconnects before reading the reply must not kill
    the daemon: replies are best-effort."""
    for payload in (b"not json\n", b'{"argv": ["not-a-command"]}\n'):
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(server)
        c.sendall(payload)
        c.close()
    assert request(server, ["not-a-command"], timeout=120) == 2


class _FakeSocket:
    """A client socket whose connect fails (EAGAIN) for the first
    ``fails`` instances made."""

    made = []
    fails = 0

    def __init__(self, *a):
        self.closed = False
        self.connected = False
        _FakeSocket.made.append(self)

    def settimeout(self, t):
        self.timeout = t

    def connect(self, path):
        if len(_FakeSocket.made) <= _FakeSocket.fails:
            raise BlockingIOError("backlog full")
        self.connected = True

    def close(self):
        self.closed = True


def test_connect_retries_with_a_fresh_socket(monkeypatch):
    """F5: each connect retry gets a new socket; each failed one is
    closed; the one returned is the one that connected."""
    monkeypatch.setattr(tserve.socket, "socket", _FakeSocket)
    monkeypatch.setattr(tserve.time, "sleep", lambda s: None)
    _FakeSocket.made, _FakeSocket.fails = [], 3
    c = tserve._connect("/unused.sock", timeout=30.0)
    made = _FakeSocket.made
    assert len(made) == 4 and len({id(s) for s in made}) == 4
    assert all(s.closed and not s.connected for s in made[:3])
    assert c is made[3] and c.connected and not c.closed
    assert c.timeout == 30.0


def test_connect_gives_up_at_the_deadline(monkeypatch):
    monkeypatch.setattr(tserve.socket, "socket", _FakeSocket)
    monkeypatch.setattr(tserve.time, "sleep", lambda s: None)
    clock = iter(range(0, 10 ** 6, 10))
    monkeypatch.setattr(tserve.time, "monotonic", lambda: next(clock))
    _FakeSocket.made, _FakeSocket.fails = [], 10 ** 6
    with pytest.raises(BlockingIOError):
        tserve._connect("/unused.sock", timeout=30.0)
    assert _FakeSocket.made and all(s.closed for s in _FakeSocket.made)
