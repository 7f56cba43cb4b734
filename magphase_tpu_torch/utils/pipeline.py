"""Threaded stage pipeline for corpus work (pure-Python copy of
magphase_tpu/utils/pipeline.py).

Each stage of an item pipeline runs on its own thread with bounded
hand-off queues, so group k+1's host preparation and upload overlap
group k's device work and group k-1's download and file writes.  The
pipelined corpus entries give each device stage its own CUDA stream
(utils/transfer.py), so the copies and the kernels overlap on the card
as the threads overlap on the host.

Replaces the reference's only scheduling construct — a multiprocessing
Pool over utterances (libutils.py:32-63) — with stage-parallel batched
scheduling.
"""
from __future__ import annotations

import os
import queue
import threading
import time

__all__ = ["run_staged"]

_STOP = object()
_TICK = 0.05


class _Cancelled(Exception):
    pass


def _put(q, x, stop_evt):
    while True:
        try:
            q.put(x, timeout=_TICK)
            return
        except queue.Full:
            if stop_evt.is_set():
                raise _Cancelled


def _get(q, stop_evt):
    while True:
        try:
            return q.get(timeout=_TICK)
        except queue.Empty:
            if stop_evt.is_set():
                raise _Cancelled


class run_staged:
    """Run ``items`` through ``stages`` (list of callables) with each
    stage on its own thread; iterate for stage-N outputs in item order.

    Work starts EAGERLY at construction (the first item begins flowing
    before the caller pulls a result) — corpus schedulers rely on this to
    overlap a batch's upload with the previous batch's compute even when
    results are collected later.

    ``depth``: max items buffered between adjacent stages (1 = classic
    double buffering: each stage holds one item, one waits).

    A stage exception cancels the pipeline and re-raises in the caller's
    thread.  Items flow strictly in order through every stage, so
    order-dependent stage state (e.g. a jit cache) behaves as in the
    serial loop.
    """

    def __init__(self, items, stages, depth: int = 1):
        self._stages = list(stages)
        self._consumed = False
        self._stop_evt = threading.Event()
        self._errors: list[BaseException] = []
        self._threads: list[threading.Thread] = []
        # per-stage wall durations per item (diagnosis: the steady-state
        # pipeline rate is set by max over stages of these)
        self.stage_times: list[list[float]] = [[] for _ in self._stages]
        if not self._stages:
            self._out_q = None
            self._items = iter(items)
            return
        stages_ = self._stages
        qs = [queue.Queue(maxsize=depth) for _ in stages_]
        self._out_q = queue.Queue(maxsize=depth)
        stop_evt = self._stop_evt
        errors = self._errors

        def feeder():
            try:
                for it in items:
                    _put(qs[0], it, stop_evt)
                _put(qs[0], _STOP, stop_evt)
            except _Cancelled:
                pass
            except BaseException as e:      # noqa: BLE001 — re-raised below
                errors.append(e)
                stop_evt.set()

        def worker(i: int):
            src = qs[i]
            dst = self._out_q if i == len(stages_) - 1 else qs[i + 1]
            try:
                while True:
                    x = _get(src, stop_evt)
                    if x is _STOP:
                        _put(dst, _STOP, stop_evt)
                        return
                    t0 = time.perf_counter()
                    y = stages_[i](x)
                    self.stage_times[i].append(time.perf_counter() - t0)
                    _put(dst, y, stop_evt)
            except _Cancelled:
                pass
            except BaseException as e:      # noqa: BLE001 — re-raised below
                errors.append(e)
                stop_evt.set()

        self._threads = [threading.Thread(target=feeder, daemon=True)]
        self._threads += [threading.Thread(target=worker, args=(i,),
                                           daemon=True)
                          for i in range(len(stages_))]
        for t in self._threads:
            t.start()

    def __iter__(self):
        # single-shot: after the first iteration the queues are drained
        # and the threads joined, so a second pass would silently yield
        # nothing (and concurrent re-entry would interleave two
        # consumers on one queue)
        if self._consumed:
            raise RuntimeError("run_staged pipelines are single-shot; "
                               "construct a new one to re-run")
        self._consumed = True
        return self._iter()

    def _iter(self):
        if self._out_q is None:
            yield from self._items
            return
        try:
            while True:
                try:
                    x = self._out_q.get(timeout=_TICK)
                except queue.Empty:
                    if self._stop_evt.is_set():
                        break
                    continue
                if x is _STOP:
                    break
                yield x
        finally:
            self._stop_evt.set()
        for t in self._threads:
            t.join()
        if os.environ.get("MAGPHASE_PIPE_STATS"):
            import sys
            print("run_staged stage_s " + " | ".join(
                "s%d: " % i + ",".join("%.3f" % t for t in ts)
                for i, ts in enumerate(self.stage_times)),
                file=sys.stderr, flush=True)
        if self._errors:
            raise self._errors[0]

    def close(self):
        self._stop_evt.set()
        for t in self._threads:
            t.join()
