"""The pitch tracker's Viterbi pass: CUDA C++ for Hopper, with its plain
torch version.

Replaces no Pallas kernel: the JAX package runs this DP on the device as a
``lax.scan`` over frames (magphase_tpu/epochs/tracker.py:_viterbi).  The
plain version is a Python loop over frames, some ten small launches a
frame; the kernel (csrc/viterbi.cu) runs forward pass and backtrack in one
launch.

What bounds it on the card: a serial chain per utterance (each frame's
costs need the last frame's), so its time is frames x the latency of one
step, not bytes and not operations.  One half-warp runs one utterance,
lane j owning state j: the 16 costs cross lanes by shuffles, the row
minimum is a shuffle butterfly, the next frames' rows are loaded ahead of
the chain, and the back-pointers go to a byte workspace in global memory
(no cap on the frame count).  ``chain_probe`` times the forward step on
register data alone: the kernel's own bound.

Dispatch is by tensor device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises (a failed build
or load included).  The wrapper counts its launches in
``viterbi.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

SOURCE = _build.CSRC / "viterbi.cu"

# the DP's transition costs (magphase_tpu/epochs/tracker.py); the kernel
# takes them as the float32 values that torch multiplies and fills with
VUV_COST = 0.20        # voicing transition cost
TRANS_W = 0.60         # cost per |log2| octave of f0 movement
# states of the kernel (kStates): N_CAND voiced candidates and unvoiced
N_STATES = 16


def viterbi_plain(local: torch.Tensor, ll_all: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """The DP as a Python loop over all T frames, the batch written out.

    local (B, T, K+1) float32 local costs and ll_all (B, T, K+1) float32
    log2 lags (state K unvoiced, its lag 0), valid (B, T) bool.  Returns
    the best state path (B, T) int64.  Transitions into an invalid frame
    are free; ties go to the lowest state (torch.min, like jnp.argmin,
    returns the first index)."""
    K = local.shape[-1] - 1
    T = local.shape[1]
    dev = local.device
    vv = torch.full((K + 1, K + 1), VUV_COST, dtype=local.dtype, device=dev)
    vv[K, K] = 0.0
    is_vv = torch.zeros((K + 1, K + 1), dtype=torch.bool, device=dev)
    is_vv[:K, :K] = True
    delta = local[:, 0]
    back = []
    for t in range(1, T):
        jump = torch.abs(ll_all[:, t - 1, :, None] - ll_all[:, t, None, :])
        trans = torch.where(is_vv, TRANS_W * jump, vv)
        trans = torch.where(valid[:, t, None, None], trans, 0.0)
        tot = delta[:, :, None] + trans                    # (B, i, j)
        best, best_i = torch.min(tot, dim=1)
        delta = best + local[:, t]
        delta = delta - torch.min(delta, dim=1, keepdim=True).values
        back.append(best_i)
    state = torch.argmin(delta, dim=1)
    states = [state]
    for best_i in reversed(back):
        state = torch.gather(best_i, 1, state[:, None])[:, 0]
        states.append(state)
    return torch.stack(states[::-1], dim=1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mp_viterbi.argtypes = [ptr] * 5 + [i32, i32, f32, f32, ptr]
    lib.mp_viterbi.restype = i32
    lib.mp_viterbi_probe.argtypes = [i32, f32, f32, ptr, ptr, ptr]
    lib.mp_viterbi_probe.restype = i32
    return lib


def _costs() -> tuple:
    return float(np.float32(TRANS_W)), float(np.float32(VUV_COST))


def chain_probe(steps: int, device) -> tuple:
    """Launch the probe of csrc/viterbi.cu: one half-warp runs ``steps``
    forward steps on register data (no load, no store).  Returns
    ((16,) float32 last costs, (1,) int64 SM cycles of the loop).  A
    measuring tool: no path of the package calls it, and it is not counted
    as a launch of the kernel."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"chain_probe: device {dev}; the probe runs on "
                         "CUDA only")
    delta = torch.empty(N_STATES, dtype=torch.float32, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    _build.launch(_library(), "mp_viterbi_probe", dev, int(steps), *_costs(),
                  delta.data_ptr(), cycles.data_ptr())
    return delta, cycles


def viterbi(local: torch.Tensor, ll_all: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """The tracker's Viterbi pass (see ``viterbi_plain`` for the contract).

    On the card: local and ll_all (B, T, 16) float32, valid (B, T) bool,
    contiguous on one device, T >= 1.  One launch runs the forward pass
    and the backtrack; the back-pointers take B x T x 16 bytes of
    workspace."""
    if local.device.type == "cpu":
        return viterbi_plain(local, ll_all, valid)
    _build.require_cuda(local, "viterbi")
    dev = local.device
    B, T, S = local.shape
    _build.check_int_range(B=B, T=T)
    if S != N_STATES or T < 1:
        raise ValueError(f"viterbi: {S} states and T={T}; the kernel takes "
                         f"{N_STATES} states and T >= 1")
    _build.check(local, "local", torch.float32, (B, T, S), dev)
    _build.check(ll_all, "ll_all", torch.float32, (B, T, S), dev)
    _build.check(valid, "valid", torch.bool, (B, T), dev)
    back = torch.empty(B, T, S, dtype=torch.uint8, device=dev)
    states = torch.empty(B, T, dtype=torch.int64, device=dev)
    _build.launch(_library(), "mp_viterbi", dev, local.data_ptr(),
                  ll_all.data_ptr(), valid.data_ptr(), back.data_ptr(),
                  states.data_ptr(), B, T, *_costs())
    _build.count_launch(viterbi)
    return states


viterbi.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"viterbi": viterbi.launches}


def reset_launch_counts() -> None:
    viterbi.launches = 0
