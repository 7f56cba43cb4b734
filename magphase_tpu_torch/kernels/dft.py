"""The real DFT, kernel K5: a radix-16 Stockham FFT in CUDA C++ for Hopper,
with its plain torch version, the tool's two-stage matmul form.

Counterpart of ``rfft_fused`` and ``irfft_fused`` (tools/dft_pallas.py:170,
:204; kernel bodies ``_rfft_kernel`` :139 and ``_irfft_kernel`` :148), the
JAX package's experimental fused matmul DFT.  The forward returns the
h = n/2+1 bins of a real row of n as separate float32 planes (re, im); the
inverse takes such planes and returns np.fft.irfft's result (it drops the
imaginary part of DC and Nyquist).  n is any power of two from 256 to
N_MAX.

The plain version is the tool's form: for n = n1 * 128, input index
j = j1*128 + j2 and output index k = k2*n1 + k1,

    X[k2*n1 + k1] = sum_j2 D2[j2,k2] TW[j2,k1] sum_j1 D1[j1,k1] x[j1*128 + j2]

and the inverse weights the bins by [1, 2, ..., 2, 1]/n (the hermitian
mirror folded into the stored bins, ``hermitian_fold_weights``), zero-pads
them to n and keeps the real part of the inverse stages.

The kernel (csrc/dft.cu) computes the same function by another
factorisation: the real row is a complex row of m = n/2 points, an FFT of
m points in registers and shared memory (radix-16 Stockham passes, plan
``fft_plan``, twiddles ``fft_twiddles``), and a pass that pairs bin k with
m - k.  It is bound by its bytes, not its operations, so it reads each
input once and writes each output once, with coalesced accesses.

Like the tool, no production path calls K5: ``torch.fft`` serves the
vocoder.  Dispatch is by tensor device and nothing else: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises (a
failed build or load included).  The wrappers count their launches in
``rfft_fused.launches`` and ``irfft_fused.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.melcep import mm
from . import _build

SOURCE = _build.CSRC / "dft.cu"

N2 = 128                   # the stage-2 length (the tool's lane width)
N_MAX = 8192               # the kernel is instantiated for n <= 8192
RADIX = 16                 # the kernel's points per thread and main radix


@functools.lru_cache(maxsize=32)
def dft_tables(n: int, inverse: bool):
    """(D1r, D1i, TWr^T, TWi^T, D2r, D2i) float32 for the n2 = 128 split,
    computed in float64 and rounded once, as the tool's ``_consts_128``
    (tools/dft_pallas.py:80-93) computes them: D1 (n1, n1) [j1, k1], TW^T
    (1, 128, n1) [j2, k1], D2 (128, 128) [j2, k2]."""
    n1 = n // N2
    sign = 2j if inverse else -2j
    j1 = np.arange(n1)
    D1 = np.exp(sign * np.pi * np.outer(j1, j1) / n1)            # (j1, k1)
    k1 = np.arange(n1)[None, :]
    j2 = np.arange(N2)[:, None]
    TWT = np.exp(sign * np.pi * j2 * k1 / n)                     # (j2, k1)
    jj2 = np.arange(N2)
    D2 = np.exp(sign * np.pi * np.outer(jj2, jj2) / N2)          # (j2, k2)

    def f32(a):
        return np.ascontiguousarray(a).astype(np.float32)

    return (f32(D1.real), f32(D1.imag), f32(TWT.real)[None],
            f32(TWT.imag)[None], f32(D2.real), f32(D2.imag))


def hermitian_fold_weights(n: int) -> np.ndarray:
    """Per-bin weights [1, 2, ..., 2, 1]/n that fold the hermitian mirror of
    an irfft input into its h = n/2+1 stored bins (the JAX package's
    core/matfft.py:135-144)."""
    h = n // 2 + 1
    w = np.full(h, 2.0, np.float32) / n
    w[0] = 1.0 / n
    w[-1] = 1.0 / n
    return w


def fft_plan(n: int, inverse: bool = False) -> list:
    """Radices of the kernel's FFT of m = n/2 points, in pass order
    (csrc/dft.cu ``radix``).  Forward: 16s (and one 2 or 4 where log2 m
    asks for it), then a tail of 2, 4 or 8, the pass next to the bins; the
    inverse runs them in reverse order."""
    bits = (int(n) // 2).bit_length() - 1
    tail = bits % 4 if bits % 4 in (1, 2) else 3
    head = bits - tail
    plan = ([RADIX] * (head // 4) + ([1 << head % 4] if head % 4 else [])
            + [1 << tail])
    return plan[::-1] if inverse else plan


@functools.lru_cache(maxsize=32)
def fft_twiddles(n: int, inverse: bool) -> np.ndarray:
    """The kernel's twiddles as float32 (re, im) pairs, shape (entries, 2),
    computed in float64 and rounded once.  For each pass after the first
    (``fft_plan(n, inverse)``), with Ns the product of the radices before
    it and R its own, W_{Ns R}^{r k} at [(r-1)*Ns + k] for 1 <= r < R,
    k < Ns; then W_n^k for k <= n/4.  W_N = exp(-2 pi i / N), or its
    conjugate for the inverse."""
    sign = 2j if inverse else -2j
    parts, ns = [], 1
    for r in fft_plan(n, inverse):
        if ns > 1:
            rk = np.outer(np.arange(1, r), np.arange(ns))
            parts.append(np.exp(sign * np.pi * rk / (ns * r)).ravel())
        ns *= r
    parts.append(np.exp(sign * np.pi * np.arange(n // 4 + 1) / n))
    w = np.concatenate(parts)
    return np.ascontiguousarray(np.stack([w.real, w.imag], -1)
                                .astype(np.float32))


@functools.lru_cache(maxsize=32)
def _device_twiddles(device: torch.device, n: int, inverse: bool):
    return torch.from_numpy(fft_twiddles(n, inverse)).to(device)


@functools.lru_cache(maxsize=32)
def _device_tables(device: torch.device, n: int, inverse: bool):
    """The tables as contiguous float32 tensors on ``device``: D1r, D1i,
    TWr (128, n1), TWi, D2r, D2i, and the fold weights (h,)."""
    d1r, d1i, twr, twi, d2r, d2i = dft_tables(n, inverse)
    arrs = (d1r, d1i, twr[0], twi[0], d2r, d2i, hermitian_fold_weights(n))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrs)


def _check_length(n: int) -> int:
    """n1 = n / 128 for a power of two 256 <= n <= N_MAX, else ValueError."""
    if not (isinstance(n, (int, np.integer)) and 256 <= n <= N_MAX
            and n & (n - 1) == 0):
        raise ValueError(f"n={n!r}: K5 takes a power of two from 256 to "
                         f"{N_MAX}")
    return int(n) // N2


def rfft_fused_plain(x: torch.Tensor, n: int):
    """K5a as torch ops: the two stages and the twiddle in float32
    (``torch.matmul`` without TF32 on the card), k = k2*n1 + k1 output
    order.  x (rows, n) float32 -> (re, im), each (rows, n/2+1)."""
    n1 = _check_length(n)
    d1r, d1i, twr, twi, d2r, d2i, _ = _device_tables(x.device, n, False)
    xt = x.reshape(-1, n1, N2).transpose(1, 2)             # [b, j2, j1]
    ar, ai = mm(xt, d1r), mm(xt, d1i)                      # [b, j2, k1]
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    brt, bit = br.transpose(1, 2), bi.transpose(1, 2)      # [b, k1, j2]
    cr = mm(brt, d2r) - mm(bit, d2i)                       # [b, k1, k2]
    ci = mm(brt, d2i) + mm(bit, d2r)
    h = n // 2 + 1
    return (cr.transpose(1, 2).reshape(-1, n)[:, :h],
            ci.transpose(1, 2).reshape(-1, n)[:, :h])


def irfft_fused_plain(zr: torch.Tensor, zi: torch.Tensor, n: int):
    """K5b as torch ops: the bins weighted in float32, zero-padded to the
    n1/2 + 1 rows of j1 they occupy, the inverse stages, the real part.
    zr, zi (rows, n/2+1) float32 -> (rows, n)."""
    n1 = _check_length(n)
    d1r, d1i, twr, twi, d2r, d2i, w = _device_tables(zr.device, n, True)
    j1u = n1 // 2 + 1
    pad = j1u * N2 - (n // 2 + 1)
    ar = torch.nn.functional.pad(zr * w, (0, pad))
    ai = torch.nn.functional.pad(zi * w, (0, pad))
    art = ar.reshape(-1, j1u, N2).transpose(1, 2)          # [b, j2, j1]
    ait = ai.reshape(-1, j1u, N2).transpose(1, 2)
    d1r, d1i = d1r[:j1u], d1i[:j1u]
    sr = mm(art, d1r) - mm(ait, d1i)                       # [b, j2, k1]
    si = mm(art, d1i) + mm(ait, d1r)
    br = sr * twr - si * twi
    bi = sr * twi + si * twr
    cr = mm(br.transpose(1, 2), d2r) - mm(bi.transpose(1, 2), d2i)
    return cr.transpose(1, 2).reshape(-1, n)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mp_rfft_fused.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
    lib.mp_rfft_fused.restype = i32
    lib.mp_irfft_fused.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
    lib.mp_irfft_fused.restype = i32
    lib.mp_dft_occupancy.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.mp_dft_occupancy.restype = i32
    return lib


def kernel_occupancy(n: int, inverse: bool) -> dict:
    """The n-point kernel's launch shape on the current card: threads and
    rows per block, dynamic shared memory per block, and the blocks the
    card keeps resident on one SM (by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    _check_length(n)
    lib = _library()
    out = (ctypes.c_int * 4)()
    rc = lib.mp_dft_occupancy(int(n), int(inverse), out)
    if rc != 0:
        raise RuntimeError(f"mp_dft_occupancy: CUDA error {rc}: "
                           f"{lib.mp_error_string(rc).decode()}")
    return dict(zip(("threads", "rows_per_block", "smem_bytes",
                     "blocks_per_sm"), out))


def _rows(t: torch.Tensor, width: int, name: str) -> torch.Tensor:
    if t.shape[-1] != width:
        raise ValueError(f"{name}: last dim {t.shape[-1]}, expected {width}")
    return t.reshape(-1, width).to(torch.float32).contiguous()


def rfft_fused(x: torch.Tensor, n: int):
    """K5a: the rfft of real x (..., n) as two float32 planes (re, im) of
    shape (..., n/2+1); n a power of two from 256 to N_MAX."""
    _check_length(n)
    h = n // 2 + 1
    lead = x.shape[:-1]
    x2 = _rows(x, n, "x")
    if x2.device.type == "cpu":
        re, im = rfft_fused_plain(x2, n)
    else:
        _build.require_cuda(x2, "rfft_fused")
        dev = x2.device
        rows = x2.shape[0]
        _build.check_int_range(rows=rows)
        if x2.data_ptr() % 8:               # the kernel loads float2
            x2 = x2.clone()
        re = torch.empty(rows, h, dtype=torch.float32, device=dev)
        im = torch.empty(rows, h, dtype=torch.float32, device=dev)
        tw = _device_twiddles(dev, n, False)
        _build.launch(_library(), "mp_rfft_fused", dev, x2.data_ptr(),
                      re.data_ptr(), im.data_ptr(), tw.data_ptr(), rows, n)
        rfft_fused.launches += 1
    return re.reshape(*lead, h), im.reshape(*lead, h)


def irfft_fused(zr: torch.Tensor, zi: torch.Tensor, n: int):
    """K5b: the real inverse of the h = n/2+1 bins (zr, zi) (..., h) as
    float32 (..., n); n a power of two from 256 to N_MAX."""
    _check_length(n)
    h = n // 2 + 1
    if zr.shape != zi.shape:
        raise ValueError(f"zr {tuple(zr.shape)} and zi {tuple(zi.shape)} "
                         "differ")
    lead = zr.shape[:-1]
    zr2, zi2 = _rows(zr, h, "zr"), _rows(zi, h, "zi")
    if zr2.device.type == "cpu" and zi2.device.type == "cpu":
        y = irfft_fused_plain(zr2, zi2, n)
    else:
        _build.require_cuda(zr2, "irfft_fused")
        dev = zr2.device
        rows = zr2.shape[0]
        _build.check_int_range(rows=rows)
        _build.check(zi2, "zi", torch.float32, (rows, h), dev)
        y = torch.empty(rows, n, dtype=torch.float32, device=dev)
        tw = _device_twiddles(dev, n, True)
        _build.launch(_library(), "mp_irfft_fused", dev, zr2.data_ptr(),
                      zi2.data_ptr(), y.data_ptr(), tw.data_ptr(), rows, n)
        irfft_fused.launches += 1
    return y.reshape(*lead, n)


rfft_fused.launches = 0
irfft_fused.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"rfft_fused": rfft_fused.launches,
            "irfft_fused": irfft_fused.launches}


def reset_launch_counts() -> None:
    rfft_fused.launches = 0
    irfft_fused.launches = 0
