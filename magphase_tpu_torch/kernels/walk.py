"""The epoch-placement walk, kernel K4: CUDA C++ for Hopper, with its plain
torch version.

Counterpart of ``_walk_kernel`` (magphase_tpu/pallas_kernels/
walk_pallas.py:51, entry ``place_epochs_pallas``), which restates
``place_epochs_kernel`` of magphase_tpu/epochs/placement_device.py.  The
CUDA source is csrc/walk.cu.

What bounds it on the card: the walk is a serial chain per utterance (each
mark starts the next window), so its time is marks x the latency of one
step, not bytes and not operations.  One block walks one utterance and
keeps global memory off that chain: the tracks become a per-frame table
of window offsets in shared memory (the walk's own float32 operations,
done once per frame; in a scratch row of global memory where a very long
utterance's table does not fit beside the ring), three producer warps keep a ring of the signal in
shared memory ahead of the one walker warp (``ring_geometry``), the
walker reads only the searched span, the minimum is two ``redux``
instructions on an order-preserving integer key, and the frame index is
a multiply-high where that equals the float32 division
(``frame_divider``).  ``chain_probe`` times the step's dependent skeleton
alone: the walk's own bound.

Dispatch is by tensor device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises (a failed build
or load included).  The wrapper counts its launches in ``walk.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

SOURCE = _build.CSRC / "walk.cu"

# the two-phase snap window (magphase_tpu/epochs/tracker.py SNAP_*)
SNAP_HALF_RUN = 0.15
SNAP_HALF_ONSET = 0.35
SNAP_ONSET_MARKS = 4

# the ring of csrc/walk.cu: the producers copy chunks of CHUNK samples
# (kChunk) into a ring of a power-of-two number of chunks, at most
# MAX_CHUNKS (kMaxChunks)
CHUNK = 2048
MIN_RING = 16384
MAX_CHUNKS = 16


def walk_constants(fs: int, frame_step: float) -> dict:
    """The walk's constants as the JAX walk rounds them: float32 frame
    step, fs, fs/50 and window multipliers; ``unv_step`` with Python's
    round (half to even: 220 at 44.1 kHz, where C's roundf gives 221)."""
    f32 = np.float32
    return dict(unv_step=int(round(0.005 * fs)),
                onset_marks=SNAP_ONSET_MARKS,
                frame_step=f32(frame_step), fs=f32(fs), p_max=f32(fs / 50.0),
                lo_wide=f32(1.0 - SNAP_HALF_ONSET),
                hi_wide=f32(1.0 + SNAP_HALF_ONSET),
                lo_run=f32(1.0 - SNAP_HALF_RUN),
                hi_run=f32(1.0 + SNAP_HALF_RUN))


def ring_geometry(fs: int) -> dict:
    """The kernel's ring for sampling rate ``fs``: ``reach``, the most
    samples beyond t that a window can touch (positions below
    t + floor(hi_wide * p_max)); ``ring`` samples, the power of two from
    MIN_RING up that holds a window and the chunk being filled twice over;
    ``chunk``.  A producer may fill chunk c once
    (c + 1) * chunk - ring <= t, so the walker at t always gets the chunks
    under [t, t + reach) because reach + chunk <= ring."""
    c = walk_constants(fs, 1.0)
    reach = int(np.floor(c["hi_wide"] * c["p_max"]))
    ring = MIN_RING
    while ring < 2 * (reach + CHUNK):
        ring *= 2
    if ring > MAX_CHUNKS * CHUNK or reach >= 2 ** 15:
        raise ValueError(f"walk: fs={fs} needs a window reach of {reach} "
                         f"samples, beyond the kernel's ring")
    return dict(reach=reach, ring=ring, chunk=CHUNK)


def frame_divider(frame_step: float, S: int):
    """(magic, shift) with trunc(float32(t) / float32(frame_step)) ==
    (t * magic) >> (32 + shift) for every integer 0 <= t <= S, or None
    where the kernel must divide in float32.  Holds for an integer step
    s >= 2 with S + s < 2^24: t is exact in float32, and the real quotient
    t / s lies at least 1/s below the next integer, more than the half ulp
    (at most (t / s + 1) * 2^-24) by which the rounded float quotient can
    exceed it, so truncation gives the integer quotient; and
    magic = ceil(2^k / s), k = 31 + floor(log2 s), overshoots 2^k / s by
    less than 2^k / (s * 2^24), too little to carry t * magic past a
    multiple of 2^k for t < 2^24."""
    step = float(np.float32(frame_step))
    s = int(step)
    if s != step or s < 2 or S + s >= 2 ** 24:
        return None
    shift = s.bit_length() - 2
    return -(-2 ** (32 + shift) // s), shift


def walk_plain(y_snap, f0, voiced, n_sigs, n_frames, *, fs: int, m_max: int,
               frame_step: float, snap_w: int):
    """K4 as a Python ``while`` over mark steps with tensor ops over the
    batch: every walker steps in lockstep until all are done, as the JAX
    package's vmapped ``lax.while_loop`` does.  Divisions are tensor by
    tensor (true float32 quotients on the CPU and the card).

    y_snap (B, S) float32; f0, voiced (B, T) float32; n_sigs, n_frames (B,)
    int32.  Returns (marks (B, m_max) int32, flags (B, m_max) float32,
    n_marks (B,) int32); entries past n_marks are 0."""
    c = walk_constants(fs, frame_step)
    B, S = y_snap.shape
    dev = y_snap.device
    i32, f32 = torch.int32, torch.float32

    def full(v, dtype=f32):
        return torch.full((B,), v, dtype=dtype, device=dev)

    step_t, fs_t = full(float(c["frame_step"])), full(float(c["fs"]))
    unv_f = full(float(c["unv_step"]))
    p_max = full(float(c["p_max"]))
    n_sigs = n_sigs.to(i32)
    fr_max = torch.clamp(n_frames.to(i32) - 1, min=0)
    offs = torch.arange(snap_w, device=dev, dtype=i32)
    t = torch.zeros(B, dtype=i32, device=dev)
    n_marks = torch.zeros_like(t)
    run_len = torch.zeros_like(t)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    marks = torch.zeros(B, m_max, dtype=i32, device=dev)
    flags = torch.zeros(B, m_max, dtype=f32, device=dev)
    while not bool(done.all()):
        fr = torch.minimum(torch.clamp(
            (t.to(f32) / step_t).to(i32), min=0), fr_max).long()[:, None]
        f0_fr = torch.gather(f0, 1, fr)[:, 0]
        is_voi = (torch.gather(voiced, 1, fr)[:, 0] > 0) & (f0_fr > 0)
        period = torch.where(is_voi, fs_t / torch.clamp(f0_fr, min=1.0),
                             unv_f)
        period = torch.minimum(period, p_max)
        wide = run_len < c["onset_marks"]
        lo_mult = torch.where(wide, full(float(c["lo_wide"])),
                              full(float(c["lo_run"])))
        hi_mult = torch.where(wide, full(float(c["hi_wide"])),
                              full(float(c["hi_run"])))
        p_lo = torch.floor(lo_mult * period).to(i32)
        p_hi = torch.floor(hi_mult * period).to(i32)
        lo = t + p_lo
        hi = torch.minimum(n_sigs - 1, t + p_hi)

        lo_slice = torch.clamp(lo, 0, S - snap_w)
        pos = lo_slice[:, None] + offs
        vals = torch.gather(y_snap, 1, pos.long())
        in_win = (pos >= torch.clamp(lo, min=0)[:, None]) & \
            (pos < hi[:, None])
        vals = torch.where(in_win, vals, float("inf"))
        nxt_voi = lo_slice + torch.argmin(vals, dim=1).to(i32)
        nxt = torch.where(is_voi, nxt_voi, t + c["unv_step"])

        last = torch.clamp(n_marks - 1, min=0).long()[:, None]
        prev = torch.where(n_marks > 0, torch.gather(marks, 1, last)[:, 0],
                           -1)
        min_adv = torch.where(is_voi, torch.clamp(p_lo, min=1), 1)
        nxt = torch.where(nxt <= prev, prev + min_adv, nxt)

        ok = ~done & (nxt < n_sigs - 1) & (hi > lo + 1) & (n_marks < m_max)
        at = torch.clamp(n_marks, max=m_max - 1).long()[:, None]
        marks.scatter_(1, at, torch.where(ok, nxt, torch.gather(
            marks, 1, at)[:, 0])[:, None])
        flags.scatter_(1, at, torch.where(ok, is_voi.to(f32), torch.gather(
            flags, 1, at)[:, 0])[:, None])
        n_marks = torch.where(ok, n_marks + 1, n_marks)
        run_len = torch.where(ok & is_voi, run_len + 1,
                              torch.where(ok, 0, run_len))
        done = done | ~ok
        t = torch.where(ok, nxt, t)
    return marks, flags, n_marks


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mp_walk.argtypes = ([ptr] * 9 + [i32] * 9 + [ctypes.c_uint, i32]
                            + [f32] * 7 + [ptr])
    lib.mp_walk.restype = i32
    lib.mp_walk_max_shared_frames.argtypes = [i32, ctypes.POINTER(i32)]
    lib.mp_walk_max_shared_frames.restype = i32
    lib.mp_walk_occupancy.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    lib.mp_walk_occupancy.restype = i32
    lib.mp_walk_chain_probe.argtypes = [i32, ctypes.c_uint, i32, f32, ptr,
                                        ptr]
    lib.mp_walk_chain_probe.restype = i32
    return lib


def _call(fn_name: str, device: torch.device, *args) -> None:
    """A C entry point that launches nothing, on ``device``."""
    lib = _library()
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}: "
                           f"{lib.mp_error_string(rc).decode()}")


@functools.lru_cache(maxsize=None)
def max_shared_frames(device: torch.device, ring_log2: int) -> int:
    """The most tracker frames whose table (8 bytes a frame) the card lets
    a block keep in shared memory beside the ring; a longer utterance's
    table goes to global memory."""
    out = ctypes.c_int()
    _call("mp_walk_max_shared_frames", device, ring_log2, ctypes.byref(out))
    return out.value


def kernel_occupancy(fs: int, T: int, device="cuda") -> dict:
    """The kernel's launch shape on the card for sampling rate ``fs`` and
    T tracker frames: threads per block, dynamic shared memory per block
    (the ring, and the frame table where it fits there), the blocks the
    card keeps resident on one SM and whether the table is in shared
    memory."""
    dev = torch.device(device)
    ring_log2 = ring_geometry(fs)["ring"].bit_length() - 1
    in_shared = int(T) <= max_shared_frames(dev, ring_log2)
    out = (ctypes.c_int * 3)()
    _call("mp_walk_occupancy", dev, ring_log2, int(T), int(in_shared), out)
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm"), out),
                table_in_shared=in_shared)


def aligned_rows(y_snap: torch.Tensor) -> torch.Tensor:
    """``y_snap`` (B, S) as the kernel's 16-byte copies need it: rows that
    start 16-byte aligned, a multiple of 4 samples apart.  The tensor
    itself where it is so (every batch the package builds: S is bucketed to
    128), else a zero-padded copy whose first S columns are ``y_snap``."""
    B, S = y_snap.shape
    if S % 4 == 0 and y_snap.data_ptr() % 16 == 0:
        return y_snap
    padded = y_snap.new_zeros(B, S + (-S) % 4)
    padded[:, :S] = y_snap
    return padded


def chain_probe(steps: int, frame_step: float, S: int,
                device) -> torch.Tensor:
    """Launch the chain probe of csrc/walk.cu: one warp runs ``steps``
    steps of the walk's dependent skeleton (the frame index as ``walk``
    takes it for rows of S samples, one table word and one window read in
    shared memory, the key, two redux) and nothing else.  Returns the
    (final position, SM cycles of the loop) as (2,) int32.  A measuring
    tool: no path of the package calls it, and it is not counted as a
    launch of K4."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"chain_probe: device {dev}; the probe runs on "
                         "CUDA only")
    out = torch.empty(2, dtype=torch.int32, device=dev)
    _build.launch(_library(), "mp_walk_chain_probe", dev, int(steps),
                  *(frame_divider(frame_step, S) or (0, 0)),
                  float(np.float32(frame_step)), out.data_ptr())
    return out


def walk(y_snap, f0, voiced, n_sigs, n_frames, *, fs: int, m_max: int,
         frame_step: float, snap_w: int):
    """K4: the batched epoch walk (see ``walk_plain`` for the contract).

    All tensors contiguous on one device: y_snap (B, S) float32 with
    S >= snap_w; f0, voiced (B, T) float32; n_sigs, n_frames (B,) int32.
    Bound on the card: the serial per-mark chain (the frame index, a
    table word, the window's shared-memory reads and two warp reductions
    per mark), not bytes.  The block keeps the ring and 8 bytes per tracker
    frame in shared memory; where T is beyond what the card grants a block
    (``max_shared_frames``: some 20,000 frames, 100 s of signal) the frame
    table goes to global memory instead."""
    if y_snap.device.type == "cpu":
        return walk_plain(y_snap, f0, voiced, n_sigs, n_frames, fs=fs,
                          m_max=m_max, frame_step=frame_step, snap_w=snap_w)
    _build.require_cuda(y_snap, "walk")
    dev = y_snap.device
    B, S = y_snap.shape
    T = f0.shape[1]
    _build.check_int_range(B=B, S=S, T=T, m_max=m_max, snap_w=snap_w)
    if S < snap_w or m_max < 1 or T < 1:
        raise ValueError(f"walk: S={S} < snap_w={snap_w}, m_max={m_max} or "
                         f"T={T} < 1")
    _build.check(y_snap, "y_snap", torch.float32, (B, S), dev)
    _build.check(f0, "f0", torch.float32, (B, T), dev)
    _build.check(voiced, "voiced", torch.float32, (B, T), dev)
    _build.check(n_sigs, "n_sigs", torch.int32, (B,), dev)
    _build.check(n_frames, "n_frames", torch.int32, (B,), dev)
    c = walk_constants(fs, frame_step)
    ring_log2 = ring_geometry(fs)["ring"].bit_length() - 1
    rows = aligned_rows(y_snap)
    tab = None
    if T > max_shared_frames(dev, ring_log2):
        tab = torch.empty(B, T, 2, dtype=torch.int32, device=dev)
    marks = torch.empty(B, m_max, dtype=torch.int32, device=dev)
    flags = torch.empty(B, m_max, dtype=torch.float32, device=dev)
    n_marks = torch.empty(B, dtype=torch.int32, device=dev)
    _build.launch(_library(), "mp_walk", dev, rows.data_ptr(),
                  f0.data_ptr(), voiced.data_ptr(), n_sigs.data_ptr(),
                  n_frames.data_ptr(), marks.data_ptr(), flags.data_ptr(),
                  n_marks.data_ptr(), tab.data_ptr() if tab is not None
                  else None, B, S, rows.shape[1], T, m_max, snap_w,
                  c["unv_step"],
                  c["onset_marks"], ring_log2,
                  *(frame_divider(frame_step, S) or (0, 0)),
                  *(float(c[k]) for k in ("frame_step", "fs", "p_max",
                                          "lo_wide", "hi_wide", "lo_run",
                                          "hi_run")))
    _build.count_launch(walk)
    return marks, flags, n_marks


walk.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"walk": walk.launches}


def reset_launch_counts() -> None:
    walk.launches = 0
