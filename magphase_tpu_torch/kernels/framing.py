"""Framing and overlap-add kernels: CUDA C++ for Hopper, with their plain
torch versions.

Counterpart of magphase_tpu/pallas_kernels/framing_pallas.py.  Three
kernels live in csrc/framing.cu:

- K1 ``frames``         replaces ``_frames_kernel`` (framing_pallas.py:56)
- K2 ``ola``            replaces ``_ola_kernel`` (framing_pallas.py:241)
- K3 ``ola_anti_ring``  replaces ``_ola_ar_kernel`` (framing_pallas.py:246)

All three are memory-bound on the card: they move far more bytes than
they compute on, so their bound is device-memory bandwidth.  K1 writes the
(B, F, N) frames, most of which are zeros (a frame holds about two pitch
periods in N samples; rows past nfrms hold nothing), so it gives one block
to each frame row: the row's scalars are read once, the row is split into
its right half, a zero span and its left half, each
thread stores 16-byte quads, and a quad wholly inside the zero span costs
no arithmetic.

The OLA is written as a gather (each output sample sums the frames
covering it, in frame order) rather than a float-atomic scatter, so it is
deterministic and bitwise equal to an in-order scatter-add.  One thread per
output sample, each searching ``starts`` and walking its covering frames
one dependent load at a time, left it latency-bound.  So K2 gives one block
to each 2,048-sample tile of one utterance's output: two warps find the
tile's run of covering frames once, the run is staged in shared memory in
chunks, and each warp loads its 256 samples of two frames at once (32
consecutive floats per load, streaming) before it adds them in frame
order; that leaves K2 bound by the frames' bytes.  K3 adds the
anti-ringing window, computed only inside its support from per-frame
scalars staged with the starts; its division and cosf are instruction
issue on about half of the elements, which is what bounds K3, and it
loads one frame at a time.

Dispatch is by tensor device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises (a failed build
or load included).  There is no fallback and no switch.  Each wrapper
counts its kernel launches in an integer, under a lock
(``_build.count_launch``, ``launch_counts``).

The kernels are built with nvcc for sm_90a into ``build/torch_kernels/``
at first use and loaded with ctypes (kernels/_build.py).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.windows import (anti_ring_window, asym_win_value,
                            asym_win_value_select)
from . import _build

SOURCE = _build.CSRC / "framing.cu"


# ---------------------------------------------------------------------------
# plain torch versions (the CPU path, and the reference on the card)

def frames_plain(sig, pm, L, R, voi, nfrms, n_sig, *, fft_len: int,
                 fam_voiced: int, fam_unvoiced: int) -> torch.Tensor:
    """K1 as vectorised indexing.  sig (B, S); pm/L/R/voi (B, F);
    nfrms/n_sig (B,).  out[b,f,p] = sig[b, clip(pm-L+q, 0, n_sig-1)] * w(q)
    with q = (p+L) mod N; 0 where q >= L+R+1 or f >= nfrms.  The window
    family is fam_voiced where voi > 0, else fam_unvoiced."""
    B, S = sig.shape
    F = pm.shape[1]
    N = fft_len
    dev = sig.device
    p = torch.arange(N, device=dev)
    L3 = L[..., None]
    R3 = R[..., None]
    q = torch.remainder(p + L3, N)
    valid = torch.arange(F, device=dev)[None, :] < nfrms[:, None]
    in_frame = (q < L3 + R3 + 1) & valid[..., None]
    last = (torch.clamp(n_sig, max=S) - 1).to(torch.int64)[:, None, None]
    idx = torch.minimum(torch.clamp((pm - L)[..., None] + q, min=0), last)
    vals = torch.gather(sig, 1, idx.reshape(B, F * N)).reshape(B, F, N)
    if fam_voiced == fam_unvoiced:
        win = asym_win_value(q, L3, R3, fam_voiced)
    else:
        win = asym_win_value_select(q, L3, R3, (voi > 0)[..., None],
                                    fam_voiced, fam_unvoiced)
    return torch.where(in_frame, vals * win, 0.0)


def ola_plain(frames, starts, nfrms, *, out_len: int) -> torch.Tensor:
    """K2 as a loop over frames: frame f of every utterance is added with
    one collision-free ``scatter_add_`` at out[b, starts[b,f] + p], in
    increasing f.  The fixed frame order makes it bitwise equal to the
    kernel.  Samples outside [0, out_len) and frames f >= nfrms go to a
    discarded slot."""
    B, F, N = frames.shape
    dev = frames.device
    buf = torch.zeros(B, out_len + 1, dtype=frames.dtype, device=dev)
    p = torch.arange(N, device=dev)
    for f in range(F):
        idx = starts[:, f:f + 1].to(torch.int64) + p
        ok = (f < nfrms)[:, None] & (idx >= 0) & (idx < out_len)
        buf.scatter_add_(1, torch.where(ok, idx, out_len), frames[:, f, :])
    return buf[:, :out_len]


def ola_anti_ring_plain(frames, starts, nfrms, wl, wr, *,
                        out_len: int) -> torch.Tensor:
    """K3 as its two passes: the anti-ringing window, then K2's plain
    version."""
    win = anti_ring_window(wl, wr, frames.shape[-1])
    return ola_plain(frames * win, starts, nfrms, out_len=out_len)


# ---------------------------------------------------------------------------
# load

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mp_frames.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.mp_frames.restype = i32
    lib.mp_ola.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.mp_ola.restype = i32
    return lib


# ---------------------------------------------------------------------------
# wrappers

def frames(sig, pm, L, R, voi, nfrms, n_sig, *, fft_len: int,
           fam_voiced: int, fam_unvoiced: int) -> torch.Tensor:
    """K1: windowed, delay-compensated pitch-synchronous frames (B, F, N).

    sig (B, S) float32; pm, L, R (B, F) int32; voi (B, F) float32;
    nfrms, n_sig (B,) int32; all contiguous, on one device.  See
    ``frames_plain`` for the definition.  Bound on the card: device-memory
    bandwidth (the (B, F, N) output written once; the signal stays in the
    L2 cache).  One block per frame row, 16-byte stores when
    fft_len % 4 == 0, single elements else."""
    if sig.device.type == "cpu":
        return frames_plain(sig, pm, L, R, voi, nfrms, n_sig, fft_len=fft_len,
                            fam_voiced=fam_voiced, fam_unvoiced=fam_unvoiced)
    _build.require_cuda(sig, "frames")
    dev = sig.device
    B, S = sig.shape
    F = pm.shape[1]
    _build.check_int_range(B=B, F=F, S=S, N=fft_len)
    _build.check(sig, "sig", torch.float32, (B, S), dev)
    for name, t in (("pm", pm), ("L", L), ("R", R)):
        _build.check(t, name, torch.int32, (B, F), dev)
    _build.check(voi, "voi", torch.float32, (B, F), dev)
    _build.check(nfrms, "nfrms", torch.int32, (B,), dev)
    _build.check(n_sig, "n_sig", torch.int32, (B,), dev)
    out = torch.empty(B, F, fft_len, dtype=torch.float32, device=dev)
    _build.launch(_library(), "mp_frames", dev, sig.data_ptr(),
                  pm.data_ptr(), L.data_ptr(), R.data_ptr(), voi.data_ptr(),
                  nfrms.data_ptr(), n_sig.data_ptr(), out.data_ptr(), B, F,
                  S, fft_len, fam_voiced, fam_unvoiced)
    _build.count_launch(frames)
    return out


def _ola_checks(frames_, starts, nfrms, out_len):
    dev = frames_.device
    B, F, N = frames_.shape
    _build.check_int_range(B=B, F=F, N=N, O=out_len)
    _build.check(frames_, "frames", torch.float32, (B, F, N), dev)
    _build.check(starts, "starts", torch.int32, (B, F), dev)
    _build.check(nfrms, "nfrms", torch.int32, (B,), dev)
    return dev, B, F, N


def ola(frames_, starts, nfrms, *, out_len: int) -> torch.Tensor:
    """K2: overlap-add, out[b, starts[b,f] + p] += frames[b,f,p] for
    f < nfrms[b], in increasing f, cut to [0, out_len).

    frames (B, F, N) float32; starts (B, F) int32; nfrms (B,) int32.
    Precondition: starts[b, :nfrms[b]] is non-decreasing (pitch marks are
    monotonic; both callers meet it by construction).  Bound on the card:
    device-memory bandwidth (each valid frame element that lands in the
    output read once, each output sample written once); the tiled gather
    keeps the loads of two frames in flight per thread."""
    if frames_.device.type == "cpu":
        return ola_plain(frames_, starts, nfrms, out_len=out_len)
    _build.require_cuda(frames_, "ola")
    dev, B, F, N = _ola_checks(frames_, starts, nfrms, out_len)
    out = torch.empty(B, out_len, dtype=torch.float32, device=dev)
    _build.launch(_library(), "mp_ola", dev, frames_.data_ptr(),
                  starts.data_ptr(), nfrms.data_ptr(), None, None,
                  out.data_ptr(), B, F, N, out_len, 0)
    _build.count_launch(ola)
    return out


def ola_anti_ring(frames_, starts, nfrms, wl, wr, *,
                  out_len: int) -> torch.Tensor:
    """K3: ``ola`` with each frame first multiplied by the anti-ringing
    window of lengths (wl, wr) (B, F) int32 (windows.anti_ring_window),
    applied at load time.  Same precondition and bytes as ``ola``; the
    window's division and cosf run only inside its support."""
    if frames_.device.type == "cpu":
        return ola_anti_ring_plain(frames_, starts, nfrms, wl, wr,
                                   out_len=out_len)
    _build.require_cuda(frames_, "ola_anti_ring")
    dev, B, F, N = _ola_checks(frames_, starts, nfrms, out_len)
    _build.check(wl, "wl", torch.int32, (B, F), dev)
    _build.check(wr, "wr", torch.int32, (B, F), dev)
    out = torch.empty(B, out_len, dtype=torch.float32, device=dev)
    _build.launch(_library(), "mp_ola", dev, frames_.data_ptr(),
                  starts.data_ptr(), nfrms.data_ptr(), wl.data_ptr(),
                  wr.data_ptr(), out.data_ptr(), B, F, N, out_len, 1)
    _build.count_launch(ola_anti_ring)
    return out


frames.launches = 0
ola.launches = 0
ola_anti_ring.launches = 0

WRAPPERS = {"frames": frames, "ola": ola, "ola_anti_ring": ola_anti_ring}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
