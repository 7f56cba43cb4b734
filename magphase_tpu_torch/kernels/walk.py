"""The epoch-placement walk, kernel K4: CUDA C++ for Hopper, with its plain
torch version.

Counterpart of ``_walk_kernel`` (magphase_tpu/pallas_kernels/
walk_pallas.py:51, entry ``place_epochs_pallas``), which restates
``place_epochs_kernel`` of magphase_tpu/epochs/placement_device.py.  The
CUDA source is csrc/walk.cu: one warp walks one utterance, with a warp
shuffle reduction for the trough.  The walk is a serial chain per
utterance (each mark starts the next window), so it is bound by latency,
not by bytes.

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
    lib.mp_walk.argtypes = [ptr] * 8 + [i32] * 7 + [f32] * 7 + [ptr]
    lib.mp_walk.restype = i32
    return lib


def walk(y_snap, f0, voiced, n_sigs, n_frames, *, fs: int, m_max: int,
         frame_step: float, snap_w: int):
    """K4: the batched epoch walk (see ``walk_plain`` for the contract).

    All tensors contiguous on one device: y_snap (B, S) float32 with
    S >= snap_w; f0, voiced (B, T) float32; n_sigs, n_frames (B,) int32.
    Bound on the card: the serial per-mark chain (a dependent lookup and a
    warp reduction per mark), not bytes."""
    if y_snap.device.type == "cpu":
        return walk_plain(y_snap, f0, voiced, n_sigs, n_frames, fs=fs,
                          m_max=m_max, frame_step=frame_step, snap_w=snap_w)
    _build.require_cuda(y_snap, "walk")
    dev = y_snap.device
    B, S = y_snap.shape
    T = f0.shape[1]
    _build.check_int_range(B=B, S=S, T=T, m_max=m_max, snap_w=snap_w)
    if S < snap_w or m_max < 1:
        raise ValueError(f"walk: S={S} < snap_w={snap_w} or m_max={m_max}")
    _build.check(y_snap, "y_snap", torch.float32, (B, S), dev)
    _build.check(f0, "f0", torch.float32, (B, T), dev)
    _build.check(voiced, "voiced", torch.float32, (B, T), dev)
    _build.check(n_sigs, "n_sigs", torch.int32, (B,), dev)
    _build.check(n_frames, "n_frames", torch.int32, (B,), dev)
    c = walk_constants(fs, frame_step)
    marks = torch.empty(B, m_max, dtype=torch.int32, device=dev)
    flags = torch.empty(B, m_max, dtype=torch.float32, device=dev)
    n_marks = torch.empty(B, dtype=torch.int32, device=dev)
    _build.launch(_library(), "mp_walk", dev, y_snap.data_ptr(),
                  f0.data_ptr(), voiced.data_ptr(), n_sigs.data_ptr(),
                  n_frames.data_ptr(), marks.data_ptr(), flags.data_ptr(),
                  n_marks.data_ptr(), B, S, T, m_max, snap_w, c["unv_step"],
                  c["onset_marks"],
                  *(float(c[k]) for k in ("frame_step", "fs", "p_max",
                                          "lo_wide", "hi_wide", "lo_run",
                                          "hi_run")))
    walk.launches += 1
    return marks, flags, n_marks


walk.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"walk": walk.launches}


def reset_launch_counts() -> None:
    walk.launches = 0
