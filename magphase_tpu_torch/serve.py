"""Persistent corpus-serving daemon (port of magphase_tpu/serve.py).

A one-shot CLI pays the interpreter and torch start-up, the kernels'
library loads, cuFFT plan creation and the first allocations on every
invocation.  `cli serve` keeps ONE process alive and serves
extract/generate/eval/convert-labels requests over a Unix socket;
`cli <cmd> --server SOCK` forwards the invocation there.

Protocol (the JAX package's): newline-delimited JSON.  Request
    {"argv": [...], "cwd": "..."}
response
    {"rc": int, "error": str|null}
plus {"shutdown": true} to stop the daemon.  Requests are served
SEQUENTIALLY (one card; concurrent corpus jobs would contend for it),
running the exact same cmd_* code paths as the one-shot CLI, so outputs
are byte-identical by construction.
"""
from __future__ import annotations

import json
import os
import socket
import sys
import time

__all__ = ["serve_forever", "request"]


def _recv_line(conn) -> bytes:
    buf = bytearray()
    while True:
        b = conn.recv(65536)
        if not b:
            break
        buf += b
        if b"\n" in b:
            break
    return bytes(buf.split(b"\n", 1)[0])


def _reply(conn, payload: bytes) -> None:
    """Best-effort reply: a client that disconnected before reading
    (timeout, Ctrl-C, stray probe) must never kill the daemon."""
    try:
        conn.sendall(payload)
    except OSError:
        pass


def serve_forever(sock_path: str, ready_cb=None) -> int:
    """Bind ``sock_path`` and serve CLI requests until shutdown.

    ``ready_cb``: optional callable invoked once the socket is listening
    (tests use it; the CLI prints a ready line)."""
    from .cli import main as cli_main

    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    # serving is sequential, but queued clients should WAIT (their turn
    # on the warm process), not bounce off a full backlog
    srv.listen(16)
    if ready_cb is not None:
        ready_cb()
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    # bound the request read: a half-open client that
                    # never sends a newline must not wedge the (strictly
                    # sequential) daemon forever
                    conn.settimeout(30.0)
                    req = json.loads(_recv_line(conn).decode())
                except Exception as e:
                    _reply(conn, json.dumps(
                        {"rc": 2, "error": f"bad request: {e}"})
                        .encode() + b"\n")
                    continue
                conn.settimeout(None)
                if req.get("shutdown"):
                    _reply(conn, b'{"rc": 0, "error": null}\n')
                    return 0
                rc, err = 2, None
                cwd0 = os.getcwd()
                try:
                    # relative paths in the request resolve against the
                    # CLIENT's cwd; serving is sequential so a per-request
                    # chdir is race-free
                    if req.get("cwd"):
                        os.chdir(req["cwd"])
                    rc = int(cli_main(list(req.get("argv", []))))
                except SystemExit as e:          # argparse errors
                    rc = int(e.code or 0)
                except Exception as e:           # reported to the client
                    err = f"{type(e).__name__}: {e}"
                finally:
                    os.chdir(cwd0)
                _reply(conn, json.dumps({"rc": rc, "error": err})
                       .encode() + b"\n")
    finally:
        srv.close()
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass


def _connect(sock_path: str, timeout: float) -> socket.socket:
    """A socket connected to ``sock_path``.  A momentarily full accept
    backlog surfaces as EAGAIN on Unix sockets (raised at once despite the
    timeout): retry briefly, with a FRESH socket each time — a socket
    whose connect failed is in an unspecified state and must not be
    reused."""
    deadline = time.monotonic() + min(timeout, 30.0)
    while True:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.settimeout(timeout)
        try:
            c.connect(sock_path)
            return c
        except (BlockingIOError, InterruptedError):
            c.close()
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)
        except BaseException:
            c.close()
            raise


def request(sock_path: str, argv=None, shutdown: bool = False,
            timeout: float = 3600.0) -> int:
    """Forward one CLI invocation to a running daemon; returns its rc."""
    with _connect(sock_path, timeout) as c:
        if shutdown:
            msg = {"shutdown": True}
        else:
            msg = {"argv": list(argv or []), "cwd": os.getcwd()}
        c.sendall(json.dumps(msg).encode() + b"\n")
        resp = json.loads(_recv_line(c).decode())
    if resp.get("error"):
        sys.stderr.write(f"server error: {resp['error']}\n")
    return int(resp["rc"])
