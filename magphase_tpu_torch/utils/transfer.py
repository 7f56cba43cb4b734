"""Host <-> device transfers of the pipelined corpus entries.

The JAX package's module of this name slices uploads into blocking chunks
to work around its host link's ordering; on a CUDA card the pipelined
entries (``parallel.batch.synthesis_batches_pipelined``,
``parallel.analysis_batch.analysis_compressed_batch_async``) give each
device stage a stream of its own instead:

- upload: numpy arrays through pinned host buffers, copied with
  ``non_blocking=True`` on the upload stream; the upload thread waits for
  its copies, so the pinned buffers are released only after they landed;
- compute: the stream waits on the upload's event and marks the uploaded
  tensors as used on it (``record_stream``), so the caching allocator does
  not hand their memory to the next upload while kernels still read it;
- download: the stream waits on the compute event, copies into pinned
  host buffers (only the valid samples of each output row) and the
  download thread waits for the copies.

Over a data mesh (parallel/mesh.py) each shard has its own three streams
on its device, and its block of rows goes up and comes down through them.
On the CPU every function degrades to plain tensor <-> numpy conversion,
with no stream.  Nothing here changes a value: the same tensors go
through the same operations whichever stream runs them.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


class Legs:
    """The upload, compute and download streams of one pipelined run: one
    of each per shard of ``mesh`` (parallel/mesh.py:DataMesh; a logical
    shard gets streams of its own on its card), None for a shard on the
    CPU."""

    def __init__(self, mesh):
        def streams():
            return [torch.cuda.Stream(d) if d.type == "cuda" else None
                    for d in mesh.devices]
        self.upload, self.compute, self.download = (streams(), streams(),
                                                    streams())


def on(stream):
    """Make ``stream`` the calling thread's current stream (torch's current
    stream is per thread); no-op for None."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def record(stream):
    """An event recorded on ``stream`` now (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def upload(arrays, device, stream):
    """numpy arrays -> tensors on ``device``, and the event after their
    copies.  On CUDA each array goes through a pinned host buffer, copied
    with ``non_blocking=True`` on ``stream`` (None: the current stream);
    the call returns once the copies have landed (the pinned buffers are
    then free to go)."""
    device = torch.device(device)
    if device.type != "cuda":
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in arrays), None
    if stream is None:
        stream = torch.cuda.current_stream(device)
    with on(stream):
        pinned = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                  for a in arrays]
        out = tuple(p.to(device, non_blocking=True) for p in pinned)
        ev = record(stream)
    ev.synchronize()
    return out, ev


def upload_sharded(arrays, mesh, streams=None) -> list:
    """numpy arrays with a common leading (batch) axis -> for each shard of
    ``mesh``, its contiguous block of rows uploaded to its device (on
    ``streams[i]``, as ``upload`` does it): a list of (tensors, event) in
    shard order."""
    n = mesh.size
    k = len(arrays[0]) // n
    if k * n != len(arrays[0]):
        raise ValueError(f"batch of {len(arrays[0])} rows does not split "
                         f"over {n} shards")
    return [upload([a[i * k:(i + 1) * k] for a in arrays], d,
                   None if streams is None else streams[i])
            for i, d in enumerate(mesh.devices)]


def adopt(tensors, stream, event) -> None:
    """Order ``stream`` after ``event`` and mark ``tensors`` (made on
    another stream) as used on it."""
    if stream is None:
        return
    stream.wait_event(event)
    for t in tensors:
        if t is not None:
            t.record_stream(stream)


def to_host(tensors, stream, event) -> list:
    """Tensors -> numpy arrays.  On CUDA the copies run on ``stream`` after
    ``event``, into pinned host buffers, and the call waits for them."""
    if stream is None:
        return [t.cpu().numpy() for t in tensors]
    with on(stream):
        adopt(tensors, stream, event)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = record(stream)
    done.synchronize()
    return [h.numpy() for h in host]


def rows_to_host(bufs, lens, stream, event) -> list:
    """Row i of the (B, O) tensor ``bufs`` cut to its first ``lens[i]``
    samples, for each i < len(lens), as numpy arrays: only those samples
    cross to the host, packed into one buffer."""
    lens = [int(n) for n in lens]
    if stream is None:
        host = bufs.cpu().numpy()
        return [host[i, :n] for i, n in enumerate(lens)]
    with on(stream):
        adopt((bufs,), stream, event)
        flat = torch.cat([bufs[i, :n] for i, n in enumerate(lens)])
    (flat,) = to_host((flat,), stream, record(stream))
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [flat[offs[i]:offs[i + 1]] for i in range(len(lens))]
