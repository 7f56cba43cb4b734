"""Host-side fan-out over utterances (copy of
magphase_tpu/utils/parallel_map.py; libutils.py:32-63 parity).

The reference's entire parallelism strategy is ``multiprocessing.Pool().map``
over wav files, one process per core.  Here the heavy compute runs on the
card, and a CUDA context does not survive a fork, so host fan-out uses a
thread pool: threads overlap the host-side work (file IO, padding, feature
packing) and the torch calls that release the interpreter lock.  For
several devices use ``magphase_tpu_torch.parallel`` (a data mesh over the
batch axis) instead.
"""
from __future__ import annotations

from multiprocessing.pool import ThreadPool


def run_multithreaded(func, *args, n_workers: int | None = None) -> list:
    """Reference-compatible fan-out (libutils.py:32-63): each ``list``
    argument is iterated element-wise, every other argument is broadcast
    to all runs.  Returns the list of per-run results (the reference
    discards them; we keep them)."""
    nruns = None
    for a in args:
        if isinstance(a, list):
            nruns = len(a)
            break
    if nruns is None:
        raise ValueError("run_multithreaded: at least one argument must be "
                         "a list (the per-run axis)")

    calls = []
    for r in range(nruns):
        calls.append(tuple(a[r] if isinstance(a, list) else a for a in args))

    with ThreadPool(n_workers) as pool:
        return pool.map(lambda c: func(*c), calls)
