"""Corpus runner: per-utterance fault isolation, crash lists, resume (copy
of magphase_tpu/utils/corpus.py; its manifest reads and writes the same
JSON, so either package's CLI resumes the other's corpus directory).

The reference's fault tolerance is a try/except appending failed tokens to
a crash ``.scp`` (batch_convert_label_state_aligned_to_variable_frame_rate.py
:48-70) and idempotent per-utterance feature files as the de-facto
checkpoint (SURVEY.md §5).  This runner keeps that contract and adds an
explicit manifest so partial corpus jobs resume exactly.
"""
from __future__ import annotations

import json
import os
import traceback
from dataclasses import dataclass, field

from .metrics import Metrics, logger


@dataclass
class CorpusResult:
    done: list = field(default_factory=list)
    skipped: list = field(default_factory=list)
    failed: list = field(default_factory=list)
    metrics: Metrics = field(default_factory=Metrics)


class Manifest:
    """JSON manifest of completed utterance tokens in an output dir."""

    def __init__(self, out_dir: str, config: dict | None = None,
                 name: str = ".magphase_manifest.json"):
        self.path = os.path.join(out_dir, name)
        self.config = config or {}
        self.done: set[str] = set()
        if os.path.exists(self.path):
            with open(self.path) as f:
                data = json.load(f)
            if config is None or data.get("config") == self.config:
                self.done = set(data.get("done", []))
            else:
                logger.warning("manifest config mismatch in %s; restarting",
                               out_dir)

    def mark(self, token: str) -> None:
        self.done.add(token)

    def save(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"config": self.config, "done": sorted(self.done)}, f)
        os.replace(tmp, self.path)


def run_corpus(tokens, process_fn, out_dir: str, config: dict | None = None,
               crash_list_path: str | None = None,
               save_every: int = 25,
               manifest_name: str = ".magphase_manifest.json"
               ) -> CorpusResult:
    """Run ``process_fn(token)`` over utterance tokens with isolation.

    Failed tokens are logged, appended to the crash list, and skipped;
    completed tokens go in the manifest and are skipped on re-runs.
    """
    os.makedirs(out_dir, exist_ok=True)
    manifest = Manifest(out_dir, config, manifest_name)
    res = CorpusResult()

    for i, tok in enumerate(tokens):
        if tok in manifest.done:
            res.skipped.append(tok)
            continue
        try:
            with res.metrics.stage("process"):
                seconds = process_fn(tok)
            if seconds:
                res.metrics.add_audio(float(seconds))
            manifest.mark(tok)
            res.done.append(tok)
        except Exception as e:  # per-utterance isolation
            logger.error("utterance %s failed: %s", tok, e)
            logger.debug("%s", traceback.format_exc())
            res.failed.append(tok)
            if crash_list_path:
                with open(crash_list_path, "a") as f:
                    f.write(tok + "\n")
        if (i + 1) % save_every == 0:
            manifest.save()
    manifest.save()
    logger.info("corpus done: %d processed, %d skipped, %d failed",
                len(res.done), len(res.skipped), len(res.failed))
    return res


def run_corpus_batched(tokens, process_batch_fn, out_dir: str,
                       batch_size: int = 8, config: dict | None = None,
                       crash_list_path: str | None = None,
                       pipeline_depth: int = 2,
                       manifest_name: str = ".magphase_manifest.json"
                       ) -> CorpusResult:
    """Run ``process_batch_fn(token_chunk) -> [audio_seconds, ...]`` over
    utterance chunks (device-batched pipelines).

    Keeps the reference's crash-list contract (SURVEY.md §5) at batch
    granularity: when a chunk fails it is retried one utterance at a time,
    so a single bad wav costs one singleton retry, not the whole chunk.

    ``process_batch_fn`` may instead return a zero-arg ``finalize``
    callable (deferred result — e.g. an async device dispatch whose
    download happens in finalize): up to ``pipeline_depth`` chunks are
    kept in flight so the next chunk's host IO + upload overlaps the
    previous chunk's device time.
    """
    from collections import deque

    os.makedirs(out_dir, exist_ok=True)
    manifest = Manifest(out_dir, config, manifest_name)
    res = CorpusResult()

    pending = []
    for tok in tokens:
        (res.skipped if tok in manifest.done else pending).append(tok)

    def record_fail(tok, e):
        logger.error("utterance %s failed: %s", tok, e)
        logger.debug("%s", traceback.format_exc())
        res.failed.append(tok)
        if crash_list_path:
            with open(crash_list_path, "a") as f:
                f.write(tok + "\n")

    def record_done(chunk, seconds):
        for tok, s in zip(chunk, seconds):
            res.metrics.add_audio(float(s))
            manifest.mark(tok)
            res.done.append(tok)
        manifest.save()

    def run_singletons(chunk):
        """Per-utterance retries isolating the failing member(s)."""
        for tok in chunk:
            try:
                with res.metrics.stage("process"):
                    r = process_batch_fn([tok])
                    if callable(r):
                        r = r()
                record_done([tok], [r[0]])
            except Exception as e:
                record_fail(tok, e)

    inflight: deque = deque()   # (chunk, finalize)

    def drain_one():
        chunk, fin = inflight.popleft()
        try:
            with res.metrics.stage("process"):
                seconds = fin()
            record_done(chunk, seconds)
        except Exception:
            run_singletons(chunk)

    for i in range(0, len(pending), batch_size):
        chunk = pending[i:i + batch_size]
        try:
            with res.metrics.stage("process"):
                r = process_batch_fn(chunk)
        except Exception:
            run_singletons(chunk)
            continue
        if callable(r):
            inflight.append((chunk, r))
            while len(inflight) >= max(1, pipeline_depth):
                drain_one()
        else:
            record_done(chunk, r)
    while inflight:
        drain_one()
    logger.info("corpus done: %d processed, %d skipped, %d failed",
                len(res.done), len(res.skipped), len(res.failed))
    return res
