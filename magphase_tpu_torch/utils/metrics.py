"""Observability: structured logging, stage timers, throughput counters
(port of magphase_tpu/utils/metrics.py).

The reference's only observability is print statements (SURVEY.md §5).
Here: a lightweight metrics registry with stage timers and audio-seconds/s
counters, and a torch.profiler hook.  The port runs in one process, so
nothing is reduced across hosts.
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from collections import defaultdict

logger = logging.getLogger("magphase_tpu_torch")


def setup_logging(level=logging.INFO) -> None:
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)


class Metrics:
    """Accumulates per-stage wall time and audio seconds processed."""

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.audio_seconds = 0.0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add_audio(self, seconds: float) -> None:
        self.audio_seconds += seconds

    def throughput(self, stage: str | None = None) -> float:
        t = self.times[stage] if stage else sum(self.times.values())
        return self.audio_seconds / t if t > 0 else 0.0

    def reduce_across_hosts(self):
        """The totals over all processes: this process's own, since the
        port runs single-process."""
        return self

    def summary(self) -> dict:
        return {
            "audio_seconds": round(self.audio_seconds, 3),
            "stages": {k: {"s": round(v, 3), "n": self.counts[k]}
                       for k, v in self.times.items()},
            "audio_s_per_s": round(self.throughput(), 2),
        }

    def log_summary(self) -> None:
        logger.info("metrics %s", json.dumps(self.summary()))


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """torch.profiler trace of the CPU and, where present, the CUDA
    activity, written as a Chrome trace under ``log_dir`` (no-op when
    ``log_dir`` is None)."""
    if log_dir is None:
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
