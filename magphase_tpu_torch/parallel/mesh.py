"""Data parallelism over devices, and the multi-process corpus helpers
(port of magphase_tpu/parallel/mesh.py).

Vocoding is independent per utterance, so a batch is split by rows over a
1-D list of devices and each device runs the whole pipeline on its own
rows: no tensor ever crosses between devices, and no device collective
exists (the JAX package's shard_map has none either).  A ``DataMesh``
holds that list; ``shard_batch`` gives each shard its contiguous block of
rows on its device (``P("data")``'s layout), and ``run_sharded`` runs a
function on every shard at once, one host thread and one CUDA stream per
shard, and hands back the per-shard results in shard order.

Multi-process corpus runs split TOKENS across processes instead
(``partition_tokens``); the only traffic between processes is host-side
(the weight digest of cli._host_partition and the metrics sum of
utils/metrics.py), over a torch.distributed gloo group that
``maybe_initialize_distributed`` opens.
"""
from __future__ import annotations

import contextlib
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the card it means now (``cuda:<current>``)."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class DataMesh:
    """A 1-D mesh: the devices the batch axis is split over, in shard
    order.  A device may appear more than once: its shards are then
    LOGICAL shards, each with its own rows, thread and stream on the same
    device (how the CPU tests split a batch over 8 shards, and how a run
    on one card exercises a split)."""

    def __init__(self, devices):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]})"


def data_mesh(n_devices: int | None = None, devices=None) -> DataMesh:
    """A mesh over ``devices``, or over every visible CUDA device (the
    first ``n_devices`` of them).  Without ``devices`` and without a CUDA
    device it raises: there is no CPU fallback (pass
    ``devices=["cpu"] * n`` for logical CPU shards)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh: no CUDA device is visible; pass "
                               "devices= (e.g. ['cpu'] * 8) for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return DataMesh(devices)


def as_mesh(mesh, device) -> DataMesh:
    """The mesh a batch entry runs on: ``mesh`` itself, or a one-shard
    mesh on ``device`` for ``mesh=None``.  Anything else raises
    ValueError."""
    if mesh is None:
        return DataMesh([device])
    if not isinstance(mesh, DataMesh):
        raise ValueError(f"mesh must be a DataMesh (parallel.mesh.data_mesh)"
                         f" or None, not {type(mesh).__name__}")
    return mesh


def batch_sharding(mesh: DataMesh, ndim: int):
    """The counterpart of the JAX package's NamedSharding(mesh,
    P("data", None, ...)): a function of the batch size that gives each
    shard's (device, row range), contiguous blocks in shard order.
    ``ndim`` is the JAX signature's; only the leading axis is split."""
    del ndim

    def ranges(n: int) -> list:
        if n % mesh.size:
            raise ValueError(f"batch of {n} rows does not split over "
                             f"{mesh.size} shards")
        k = n // mesh.size
        return [(d, range(i * k, (i + 1) * k))
                for i, d in enumerate(mesh.devices)]
    return ranges


def shard_batch(mesh: DataMesh, *tensors):
    """Each tensor (or numpy array) split by its leading axis into
    ``mesh.size`` contiguous blocks, block i on ``mesh.devices[i]``: a list
    of per-shard blocks per tensor (the list alone for one tensor).  The
    leading axis must divide evenly (pad_batch_to_devices)."""
    out = []
    for t in tensors:
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        out.append([t[r.start:r.stop].to(d) for d, r in
                    batch_sharding(mesh, t.ndim)(t.shape[0])])
    return out if len(out) > 1 else out[0]


def _tensors(x):
    """The tensors of a (nested) tuple or list."""
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (tuple, list)):
        for a in x:
            yield from _tensors(a)


def _on(device, stream):
    """The device and stream context a shard's work runs under."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def run_sharded(impl, mesh: DataMesh, args=(), static_kw=None,
                streams=None) -> list:
    """The counterpart of the JAX package's sharded_kernel: ``impl(*shard
    i's args, **static_kw)`` for every shard i, on shard i's device; the
    results as a list in shard order.  ``args``: one list of per-shard
    blocks per argument (shard_batch's output, or blocks an earlier call
    returned).

    A one-shard mesh runs on the calling thread.  Otherwise each shard
    runs on a thread of its own, under its device and a stream of its own
    (``streams[i]`` if given, else a fresh one ordered after the caller's
    current stream on that device, whose results the caller's stream then
    waits for), so kernels of different shards overlap on a card.  With
    ``streams`` given the caller orders the streams itself
    (utils/transfer.py).  An exception of any shard re-raises here after
    every shard has ended."""
    static_kw = static_kw or {}
    n = mesh.size
    for a in args:
        if len(a) != n:
            raise ValueError(f"{len(a)} blocks for a mesh of {n} shards")
    per_shard = [tuple(a[i] for a in args) for i in range(n)]
    cuda = [d.type == "cuda" for d in mesh.devices]
    callers = [torch.cuda.current_stream(d) if c else None
               for d, c in zip(mesh.devices, cuda)]
    own = streams is None
    if own and n == 1:
        streams = callers
    elif own:
        streams = [torch.cuda.Stream(d) if c else None
                   for d, c in zip(mesh.devices, cuda)]
        for s, c in zip(streams, callers):
            if s is not None:
                s.wait_stream(c)

    def shard(i):
        with _on(mesh.devices[i], streams[i]):
            out = impl(*per_shard[i], **static_kw)
            ev = None
            if own and streams[i] is not None and streams[i] != callers[i]:
                ev = torch.cuda.Event()
                ev.record(streams[i])
        return out, ev

    if n == 1:
        done = [shard(0)]
    else:
        with ThreadPoolExecutor(max_workers=n) as pool:
            futs = [pool.submit(shard, i) for i in range(n)]
        done = [f.result() for f in futs]       # every shard has ended
    out = []
    for i, (res, ev) in enumerate(done):
        if ev is not None:
            callers[i].wait_event(ev)
            for t in _tensors(res):
                if t.device.type == "cuda":
                    t.record_stream(callers[i])
        out.append(res)
    return out


def unzip(results) -> tuple:
    """Per-shard result tuples -> one list of per-shard blocks per output
    (the ``args`` form of run_sharded)."""
    return tuple(list(x) for x in zip(*results))


def synchronize(mesh: DataMesh) -> None:
    """Wait for every card of the mesh (torch.cuda.synchronize() waits for
    the current device only)."""
    for d in sorted({d for d in mesh.devices if d.type == "cuda"},
                    key=str):
        torch.cuda.synchronize(d)


def pad_batch_to_devices(n: int, n_devices: int) -> int:
    """Batch size padded to a multiple of the device count."""
    return int(np.ceil(n / n_devices)) * n_devices


def batch_step(mesh: DataMesh | None, base: int = 8) -> int:
    """Bucket step for the batch axis: a multiple of ``base`` that the
    mesh size divides (even sharding)."""
    if mesh is None:
        return base
    return math.lcm(base, mesh.size)


def capped_batch_step(mesh: DataMesh | None, max_b: int,
                      base: int = 8) -> int:
    """batch_step capped by a budget-derived batch cap.  Both operands are
    multiples of the mesh size (batch_step lcm's it; budget_batch_cap
    rounds max_b), so the min keeps the split even."""
    return min(batch_step(mesh, base), max(1, max_b))


def budget_batch_cap(mesh: DataMesh | None, max_b: int,
                     base: int = 8) -> int:
    """Round a budget-derived batch cap down so that batch-axis bucketing
    never exceeds it: bucket(n <= cap, capped_batch_step(mesh, cap)) <=
    cap.  Caps at or above the batch step become multiples of the step;
    smaller caps are rounded to the mesh size (forced up to it: a split
    needs at least one row per shard)."""
    step = batch_step(mesh, base)
    if max_b >= step:
        return (max_b // step) * step
    if mesh is not None:
        return max(mesh.size, (max_b // mesh.size) * mesh.size)
    return max(1, max_b)


def rank() -> int:
    """This process's rank in the gloo group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes in the gloo group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def partition_tokens(tokens, process_index: int | None = None,
                     process_count: int | None = None, weights=None):
    """This process's share of a corpus token list.

    Corpus work is independent per utterance, so multi-process runs split
    TOKENS across processes (each batching over its own devices).
    ``weights``: optional per-token durations (audio seconds, or any
    proportional cost); tokens then go heaviest first to the least-loaded
    process (LPT bin packing).  Without weights: round-robin.
    Deterministic either way, so every process computes the same global
    assignment from the same list, and the shares are a disjoint cover;
    per-utterance noise keys derive from the GLOBAL scp index, so the
    split never changes an output byte.  This process's tokens come back
    in their original order.  ``process_index``/``process_count`` default
    to the gloo group's rank and size."""
    if process_count is None:
        process_count, process_index = world_size(), rank()
    if process_count <= 1:
        return list(tokens)
    tokens = list(tokens)
    if weights is None:
        return tokens[process_index::process_count]
    if len(weights) != len(tokens):
        raise ValueError(f"weights length {len(weights)} != "
                         f"tokens length {len(tokens)}")
    # LPT: heaviest first, each onto the least-loaded process; ties broken
    # by (load, process index) and by original index within equal weights,
    # so the assignment is identical in every process
    order = sorted(range(len(tokens)), key=lambda i: (-float(weights[i]), i))
    loads = [0.0] * process_count
    mine = []
    for i in order:
        h = min(range(process_count), key=lambda j: (loads[j], j))
        loads[h] += float(weights[i])
        if h == process_index:
            mine.append(i)
    return [tokens[i] for i in sorted(mine)]


def _group_env():
    """(init_method, world_size, rank) from torchrun's variables
    (MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK) or the JAX package's
    (JAX_COORDINATOR_ADDRESS host:port, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID); None in a single-process environment."""
    env = os.environ
    if "JAX_COORDINATOR_ADDRESS" in env:
        for k in ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
            if k not in env:
                raise RuntimeError(f"JAX_COORDINATOR_ADDRESS is set but {k} "
                                   "is not")
        return (f"tcp://{env['JAX_COORDINATOR_ADDRESS']}",
                int(env["JAX_NUM_PROCESSES"]), int(env["JAX_PROCESS_ID"]))
    if int(env.get("WORLD_SIZE", "1")) > 1:
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
            if k not in env:
                raise RuntimeError(f"WORLD_SIZE > 1 but {k} is not set")
        return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                int(env["WORLD_SIZE"]), int(env["RANK"]))
    return None


def maybe_initialize_distributed() -> None:
    """Open the gloo process group of a multi-process run; a no-op in a
    single process and when the group is open already.  gloo, because
    the only traffic between processes is host-side (the weight digest
    and the metrics sum); NCCL is not used.  A failed initialisation (an
    unreachable or mistyped address) raises: carrying on as one process
    would make every process run the WHOLE corpus and race on one
    manifest."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    spec = _group_env()
    if spec is None:
        return
    init_method, world, rank = spec
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
