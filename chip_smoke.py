"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Builds the CUDA kernels from magphase_tpu_torch/csrc (framing.cu: K1-K3,
walk.cu: K4, dft.cu: K5; one nvcc per source, started together), checks
each against its plain torch version at the shapes its path gives it (K1
beside a device fill of its output, K4 beside the chain probe that gives
the walk's own bound), then
drives the port's paths, each with the launch counts set to 0 just before
it and read just after:

- serving: the lossless analysis/synthesis round trip on synthetic
  voiced/unvoiced signals (K1 + K2), the anti-ringing overlap-add entry
  ola_centered_batch(ar_shifts=) (K3) against the two-pass form, and three
  requests of batched compressed synthesis (1, 8 and 128 utterances of
  ~3 s at 48 kHz, 60/45 feature dims; K2);
- wav-in compressed analysis: analysis_compressed_batch requests of 8 and
  192 utterances of 3 s at 48 kHz (fft_len 4096, 60/45 dims, tracked
  epochs; K4 in phase 1, K1 in phase 2), after a tracked lossless witness
  (tracker + K4 marks -> K1 -> K2), with the card against the CPU on the
  8-utterance request;
- the K5 lossless witness: the 16 exact-mark witness signals through K1,
  the fused forward DFT (K5a), the lossless features, the fused inverse
  DFT (K5b) and K2 (K5 is on no production path, as in the JAX package);
- lossless copy-synthesis: copy_synthesis_batch requests of 8 and 192
  utterances of 3 s (tracker + K4, K1 + rfft, irfft + K2), each output
  held to its input, the phase split of one group, the card against the
  CPU on 8 utterances, and analysis_lossless_batch from given epochs on
  the card against the CPU.

``--profile`` adds a torch.profiler pass over one warm 128-utterance
serving request, one warm 192-utterance analysis request and one warm
192-utterance copy-synthesis request: the host halves' times, device time
by kernel and the device's idle share.  Every
phase raises on failure.  Prints one line per phase, then a JSON line
with each kernel's launches, error, times and bound, the card's name and
power limit, and last {"ok": true, "device": {...}}.

Needs a CUDA card: exits non-zero without one, and never falls back to
the CPU.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

FS = 48000
MAG_DIM, PHASE_DIM = 60, 45
UTT_SECONDS = 3.0
REQUEST_SIZES = (1, 8, 128)
ANALYSIS_SIZES = (8, 192)
ANALYSIS_DISTINCT = 32      # distinct signals, cycled as bench.py:327 does
CSRC = "magphase_tpu_torch/csrc"
PALLAS = "magphase_tpu/pallas_kernels"
SOURCES = {"frames": f"{CSRC}/framing.cu", "ola": f"{CSRC}/framing.cu",
           "ola_anti_ring": f"{CSRC}/framing.cu", "walk": f"{CSRC}/walk.cu",
           "rfft_fused": f"{CSRC}/dft.cu", "irfft_fused": f"{CSRC}/dft.cu"}
REPLACES = {"frames": f"{PALLAS}/framing_pallas.py:56",
            "ola": f"{PALLAS}/framing_pallas.py:241",
            "ola_anti_ring": f"{PALLAS}/framing_pallas.py:246",
            "walk": f"{PALLAS}/walk_pallas.py:51",
            "rfft_fused": "tools/dft_pallas.py:139",
            "irfft_fused": "tools/dft_pallas.py:148"}
# the card's peaks (NVIDIA's H100 SXM data sheet, dense float32, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K1 and K3 may differ from their plain versions by float32 round-off
# (both are written to round every operation as the plain version does,
# but the window's cosf is the only libm call); K2 must be bitwise equal.
TOL_FRAMES = 1e-6
TOL_OLA_AR = 1e-6
# lossless round trip: the p99 bar of one PCM16 step (bench.py's witness)
TOL_LOSSLESS_P99 = 2.0 ** -15
# CUDA vs CPU on one request, as max|gpu - cpu| / peak|cpu|.  The CPU
# tests measure the port against the JAX package at up to 1.8e-6 of the
# peak (float32 FFT and matmul round-off, tests/test_torch_slice.py); the
# card adds cuFFT's and cuBLAS's own rounding at 4x longer FFTs, so the
# bound is ten times the CPU-measured difference.
TOL_CUDA_VS_CPU = 2e-5
# analysis, CUDA vs CPU on the 8-utterance request, on frames whose marks
# agree: the CPU tests measure the port's phase 2 against the JAX package
# at up to 8.0e-5 absolute on the mel streams (the phase coefficients of
# weak frames) and 1.1e-7 relative on lf0, on a witness signal of this
# script at fft_len 4096 (tests/test_torch_analysis.py::
# test_phase2_layer_matches_jax_native_rfft); the bounds are ten times
# those.  The marks themselves may move where the card's round-off shifts
# a trough: at most 0.5% of them, by at most one sample.
TOL_ANALYSIS_STREAMS = 8e-4
TOL_ANALYSIS_LF0_REL = 1.1e-6
MAX_MARK_DIFF_SHARE = 0.005
# K5 against its plain version: the bounds of the JAX package's own tests
# of the tool (tests/test_dft_pallas.py), which the port's plain version
# meets against the tool on the CPU (tests/test_torch_dft.py): the forward
# within 1e-5 of the spectrum's peak, the inverse within 1e-6 absolute on
# unit-scale bins.  Both sum in float32, in another order.
TOL_RFFT_REL = 1e-5
TOL_IRFFT_ABS = 1e-6
# lossless features from given epochs, CUDA vs CPU: the CPU tests measure
# the port against the JAX package at 1.8e-7 of the peak on magnitudes and
# 5.0e-5 on phasors where the bin is above 1e-3 of the peak
# (tests/test_torch_lossless.py); the bounds are ten times those
TOL_LOSSLESS_MAG_REL = 1.8e-6
TOL_LOSSLESS_PHASOR = 5e-4
# warm runs per request size; the median and the spread are reported
WARM_RUNS = 10
WARM_RUNS_ANALYSIS = 5
WARM_RUNS_COPY = 3
COPY_SIZES = (8, 192)


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_report(build_log: str) -> list:
    """One entry per kernel of ptxas -v's report: registers, stack frame,
    spills and static shared memory, under the kernel's name and template
    arguments."""
    out, name, spill = [], "?", []
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"\d+((?:[a-z]+_)*kernel)(?:I((?:L[ib]\d+E)+))?",
                          ln)
            targs = re.findall(r"L[ib](\d+)E", m.group(2) or "") if m else []
            name = (f"{m.group(1)}<{','.join(targs)}>" if targs
                    else m.group(1) if m else ln.split("'")[1])
        elif "spill stores" in ln:
            spill = re.findall(r"(\d+) bytes (?:stack|spill)", ln)
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name} {regs} regs, stack/spill st/ld "
                       f"{'/'.join(spill)} B, "
                       f"smem {smem.group(1) if smem else 0} B")
    return out


def nvidia_smi() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    res = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# synthetic data, all from numpy with --seed

def make_witness_signals(rng, n: int, seconds: float):
    """Voiced/unvoiced test signals with their exact pitch marks: an f0
    contour in 80-300 Hz, voiced runs as damped two-formant pulses at each
    mark, unvoiced runs as noise with marks every 5 ms."""
    from scipy import signal as sp_signal
    n_sig = int(seconds * FS)
    sigs, marks, vois = [], [], []
    t_ir = np.arange(int(0.02 * FS)) / FS
    ir = (np.exp(-t_ir * 400) * np.sin(2 * np.pi * 700 * t_ir)
          + 0.5 * np.exp(-t_ir * 600) * np.sin(2 * np.pi * 1800 * t_ir))
    for _ in range(n):
        f0_lo, f0_hi = 80.0, 300.0
        ph = rng.uniform(0, 2 * np.pi)
        pm, voi = [], []
        t = int(rng.integers(100, 300))
        voiced = True
        run_end = t + int(rng.uniform(0.2, 0.5) * FS)
        while t < n_sig - 700:
            if t >= run_end:
                voiced = not voiced
                run_end = t + int(rng.uniform(0.2, 0.5) * FS
                                  if voiced else rng.uniform(0.05, 0.15) * FS)
            f0 = f0_lo + (f0_hi - f0_lo) * 0.5 * (1 + np.sin(
                2 * np.pi * 0.7 * t / FS + ph))
            pm.append(t)
            voi.append(1.0 if voiced else 0.0)
            t += int(FS / f0) if voiced else 240
        pm = np.asarray(pm, np.int64)
        voi = np.asarray(voi)
        pulses = np.zeros(n_sig)
        pulses[pm[voi > 0]] = 1.0
        x = sp_signal.fftconvolve(pulses, ir)[:n_sig]
        uv = np.zeros(n_sig, bool)
        for a, b, v in zip(pm[:-1], pm[1:], voi[:-1]):
            if v == 0:
                uv[a:b] = True
        x = x + np.where(uv, 0.05 * rng.standard_normal(n_sig), 0.0)
        x = 0.3 * x / np.abs(x).max()
        sigs.append(x.astype(np.float32))
        marks.append(pm)
        vois.append(voi)
    return sigs, marks, vois


def make_features(rng, seconds: float):
    """One utterance of synthetic predicted features at the pitch-sync
    frame rate: smooth log-mag around -3, unit phasor coefficients in
    [-1, 1] (zero on unvoiced frames), lf0 in 90-250 Hz with ~30% of the
    frames in unvoiced runs."""
    from scipy.ndimage import gaussian_filter
    n_max = int(seconds * 250) + 8
    ph = rng.uniform(0, 2 * np.pi)
    f0 = 170.0 + 80.0 * np.sin(np.linspace(0, 3 * np.pi, n_max) + ph)
    voi = np.ones(n_max, bool)
    i = int(rng.integers(10, 40))
    while i < n_max:
        run = int(rng.integers(8, 25))
        voi[i:i + run] = False
        i += run + int(rng.integers(25, 60))
    shifts = np.where(voi, FS / f0, 240.0)
    n = int(np.searchsorted(np.cumsum(shifts), seconds * FS)) + 1

    def smooth(shape, sigma):
        g = gaussian_filter(rng.standard_normal(shape), sigma)
        return g / g.std()

    mag = -3.0 + 0.5 * smooth((n, MAG_DIM), (6, 2)) \
        - np.linspace(0.0, 2.0, MAG_DIM)[None, :]
    ang = np.pi * smooth((n, PHASE_DIM), (4, 1))
    v = voi[:n, None]
    real = np.where(v, np.cos(ang), 0.0)
    imag = np.where(v, np.sin(ang), 0.0)
    lf0 = np.where(voi[:n], np.log(f0[:n]), -1.0e10)
    return mag, real, imag, lf0


def expected_out_len(lf0) -> int:
    """Output length from the features alone (magphase.py:879-880,
    58-60): integer shifts with the 1e-5 truncation guard, 5 ms unvoiced."""
    f0 = np.exp(np.asarray(lf0, np.float64))
    shift = np.floor(FS / np.where(f0 == 0.0, 200.0, f0) * (1.0 + 1e-5))
    pm = np.cumsum(shift.astype(np.int64))
    return int(2 * pm[-1] - pm[-2] + 1)


# ---------------------------------------------------------------------------

def _busy_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_call(label: str, fn) -> None:
    """One warm call of fn under torch.profiler: its wall time, the
    device's busy time and idle share over the call's span (the part in
    which no kernel, copy or memset ran), and device time by kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("request"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    req = [e for e in events if e.get("name") == "request"
           and e.get("cat") == "user_annotation"]
    dev_ev = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if len(req) != 1 or not dev_ev:
        raise AssertionError(f"profile: {len(req)} request spans and "
                             f"{len(dev_ev)} device events in the trace")
    lo, hi = req[0]["ts"], req[0]["ts"] + req[0]["dur"]
    busy = _busy_us(dev_ev, lo, hi)
    log(f"[profile] {label} under the profiler: wall {wall * 1000:.1f} ms, "
        f"span {(hi - lo) / 1000:.3f} ms, device busy {busy / 1000:.3f} ms, "
        f"idle share {1 - busy / (hi - lo):.4f}")

    # device time by kernel, from the trace's device events alone (the
    # profiler's per-op table would count a kernel under its op as well)
    by_kernel: dict[str, float] = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            k = (_kernel_label(e["name"]) if e["cat"] == "kernel"
                 else e["name"])
            by_kernel[k] = by_kernel.get(k, 0.0) + e["dur"]
    top = sorted(by_kernel.items(), key=lambda kv: kv[1], reverse=True)
    log(f"[profile] {label}: device time {sum(by_kernel.values()) / 1000:.3f}"
        f" ms in {len(dev_ev)} device events; by kernel (ms): "
        + ", ".join(f"{k} {us / 1000:.3f}" for k, us in top[:16]))


def profile_request(feats, keys, dev, reps: int = 5) -> None:
    """Where the time of one warm 128-utterance serving request goes: the
    host halves timed alone (median of ``reps``), then the request under
    torch.profiler (profile_call)."""
    from magphase_tpu_torch.parallel import batch
    geo, prep = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, max_b = batch._synthesis_geometry(feats, FS, 4096, False)
        t1 = time.perf_counter()
        batch._prepare_synthesis_group(feats, n_real=len(feats), keys=keys,
                                       max_b=max_b, fs=FS, mag_dim=MAG_DIM,
                                       phase_dim=PHASE_DIM)
        geo.append(t1 - t0)
        prep.append(time.perf_counter() - t1)
    log(f"[profile] host, median of {reps}: _synthesis_geometry "
        f"{np.median(geo) * 1000:.3f} ms, _prepare_synthesis_group "
        f"{np.median(prep) * 1000:.3f} ms")
    profile_call(f"serving request of {len(feats)} utts",
                 lambda: batch.synthesis_from_compressed_batch(
                     feats, FS, pf_type="magphase", keys=keys, device=dev,
                     block_result=False))


def profile_analysis(a_sigs, dev, reps: int = 5) -> None:
    """Where the time of one warm 192-utterance analysis request goes: the
    host packing of one group timed alone (median of ``reps``), then the
    request under torch.profiler (profile_call)."""
    from magphase_tpu_torch.parallel import analysis_batch as ab
    req = [a_sigs[i % len(a_sigs)] for i in range(max(ANALYSIS_SIZES))]
    prep = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ab._host_signal_batch(a_sigs, FS, 4096)
        prep.append(time.perf_counter() - t0)
    log(f"[profile] host, median of {reps}: _host_signal_batch of one group "
        f"of {len(a_sigs)} {np.median(prep) * 1000:.3f} ms")
    profile_call(f"analysis request of {len(req)} utts",
                 lambda: ab.analysis_compressed_batch(req, FS, device=dev))


def _kernel_label(name: str) -> str:
    """A short label for a CUDA kernel's mangled template name: the port's
    own kernel (a name that starts in an anonymous namespace), the elementwise functor
    or the ``*_kernel_impl``/``*_kernel_cuda`` lambda it runs, else the
    name up to its template arguments."""
    m = re.match(r"\s*(?:void\s+)?\(anonymous namespace\)::(\w+)", name)
    if m:
        return m.group(1)
    m = re.search(r"(\w+_kernel_(?:impl|cuda))\b", name)
    if m:
        return m.group(1)
    functors = re.findall(r"(\w*Functor\w*<[\w:]+)", name)
    if functors:
        return functors[-1] + ">"
    m = re.match(r"\s*(?:void\s+)?([\w:]+)", name)
    return m.group(1).rsplit("::", 1)[-1] if m else name


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work, the larger
# of bytes over the memory rate and float32 operations over the peak rate

def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def walk_work(f0, n_sigs, n_frames, marks, flags, n_marks, fs: int,
              frame_step: float):
    """What this run's walk needed: (window samples read, steps), from its
    marks.  Each written mark i starts at t = the previous mark (0 for the
    first); a voiced step reads y_snap over [lo, hi) of the two-phase
    window around t + period, an unvoiced step reads nothing of it.  The
    final step that ends each walk is counted as a step without a read."""
    from magphase_tpu_torch.kernels.walk import walk_constants
    c = walk_constants(fs, frame_step)
    f0 = f0.cpu().numpy()
    marks, flags = marks.cpu().numpy(), flags.cpu().numpy()
    n_marks, n_sigs = n_marks.cpu().numpy(), n_sigs.cpu().numpy()
    n_frames = n_frames.cpu().numpy()
    samples, steps = 0, 0
    for b in range(len(n_marks)):
        n = int(n_marks[b])
        steps += n + 1
        if n == 0:
            continue
        t = np.concatenate([[0], marks[b, :n - 1]]).astype(np.int64)
        voi = flags[b, :n] > 0
        fr = np.clip((t / float(c["frame_step"])).astype(np.int64), 0,
                     max(int(n_frames[b]) - 1, 0))
        period = np.minimum(fs / np.maximum(f0[b, fr], 1.0), c["p_max"])
        run = np.zeros(n, np.int64)             # voiced marks before i in
        for i in range(1, n):                   # the current run
            run[i] = run[i - 1] + 1 if voi[i - 1] else 0
        wide = run < c["onset_marks"]
        lo = t + np.floor(np.where(wide, c["lo_wide"], c["lo_run"])
                          * period).astype(np.int64)
        hi = np.minimum(int(n_sigs[b]) - 1, t + np.floor(
            np.where(wide, c["hi_wide"], c["hi_run"]) * period).astype(
                np.int64))
        samples += int(np.sum(np.where(voi, np.maximum(hi - lo, 0), 0)))
    return samples, steps


CHAIN_PROBE_STEPS = 61200


def walk_chain_ns(dev, frame_step: float, S: int):
    """(ns, SM cycles) per step of the walk's dependent skeleton alone (one
    warp, its data in shared memory: the frame index as K4 takes it for
    rows of S samples, a table word, a window read, the key, two redux),
    by the probe kernel of csrc/walk.cu: what a step of K4 cannot go below
    on this card.  The ns are CUDA events around whole launches, the
    cycles the probe's own clock64 around its loop."""
    from magphase_tpu_torch.kernels import walk as K4
    ms = cuda_ms(lambda: K4.chain_probe(CHAIN_PROBE_STEPS, frame_step, S,
                                        dev), reps=5, warmup=1)
    cycles = int(K4.chain_probe(CHAIN_PROBE_STEPS, frame_step, S, dev)[1])
    return ms * 1e6 / CHAIN_PROBE_STEPS, cycles / CHAIN_PROBE_STEPS


def probe_sass(library: str, nvcc: str) -> str:
    """The SASS size of the chain probe's step in the built library, by
    cuobjdump: the instructions of the largest loop of
    chain_probe_kernel<true> (a backward branch and everything from its
    target on), the REDUX among them (two a step, so the loop's steps) and
    the instructions per step.  cuobjdump is looked for beside ``nvcc``."""
    exe = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc),
                                                    "cuobjdump")
    if not os.path.isfile(exe):
        return "cuobjdump not found: SASS not counted"
    sass = subprocess.run([exe, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    body = re.search(r"Function : \w*chain_probe_kernelILb1E\w*\n(.*?)"
                     r"(?=\n\s*Function :|\Z)", sass, re.S)
    if body is None:
        return "chain_probe_kernel<true> not in cuobjdump's listing"
    body = body.group(1)
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4})\*/\s+([^;]+);", body)]
    loops = []
    for addr, op in ins:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) <= addr:
            loops.append([o for a, o in ins
                          if int(m.group(1), 16) <= a <= addr])
    loops = [lp for lp in loops if any("REDUX" in o for o in lp)]
    if not loops:
        return f"{len(ins)} instructions, no loop with REDUX recognised"
    loop = max(loops, key=len)
    redux = sum("REDUX" in o for o in loop)
    return (f"{len(ins)} instructions, the loop {len(loop)} with {redux} "
            f"REDUX: {len(loop) / (redux / 2):.1f} instructions per step")


def period_errors(marks, flags, n_marks, true_marks, true_vois):
    """Relative error of each tracked voiced period (two consecutive voiced
    marks) against the witness's true period at the same place."""
    errs = []
    marks, flags, n_marks = (x.cpu().numpy() for x in (marks, flags,
                                                       n_marks))
    for b in range(len(true_marks)):
        m = marks[b, :int(n_marks[b])].astype(np.int64)
        v = flags[b, :int(n_marks[b])] > 0
        pm, pv = np.asarray(true_marks[b]), np.asarray(true_vois[b]) > 0
        both = v[:-1] & v[1:]
        j = np.searchsorted(pm, m[:-1], side="right") - 1
        ok = both & (j >= 0) & (j < len(pm) - 1)
        j = np.clip(j, 0, len(pm) - 2)
        ok &= pv[j] & pv[j + 1]
        true_p = (pm[j + 1] - pm[j]).astype(np.float64)
        errs.append(np.abs(np.diff(m) - true_p)[ok] / true_p[ok])
    return np.concatenate(errs)


def agreeing_frames(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Frames f whose marks agree at f-2 .. f+2 (every input of frame f's
    streams and of its median-smoothed lf0)."""
    eq = a == b
    pad = np.concatenate([[True, True], eq, [True, True]])
    return np.all([pad[k:k + len(eq)] for k in range(5)], axis=0)


def run_analysis_path(dev, a_sigs, a_marks, a_vois, group, Tmax, m_max,
                      S) -> dict:
    """Path 2, wav-in compressed analysis: the tracked lossless witness,
    then the analysis requests with the launch counts from 0 (returned),
    warm timings, the phase split on one group, and the card against the
    CPU on the 8-utterance request."""
    from magphase_tpu_torch.epochs import placement_device as pd
    from magphase_tpu_torch.epochs import tracker
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.kernels import walk as K4
    from magphase_tpu_torch.parallel import analysis_batch as ab
    from magphase_tpu_torch.utils.padding import bucket_frames
    from magphase_tpu_torch.vocoder import lossless
    from magphase_tpu_torch.vocoder.compressed import (
        get_num_full_mel_coeffs_from_num_phase_coeffs)
    t_sig, t_nsig, t_nfrm = group

    # tracked lossless witness: the tracker's marks -> K1 -> K2
    marks, flags, n_marks = pd.track_and_place_batch(
        t_sig, t_nsig, t_nfrm, fs=FS, n_frames_max=Tmax, m_max=m_max)
    errs = period_errors(marks, flags, n_marks, a_marks, a_vois)
    log(f"[analysis] tracked marks of {len(a_sigs)} witness signals: "
        f"{int(n_marks.sum())} marks; voiced period error vs the exact "
        f"marks: median {np.median(errs):.4g}, p95 "
        f"{np.percentile(errs, 95):.4g}, share > 20% {np.mean(errs > 0.2):.4g}"
        f" over {len(errs)} periods")
    F = min(m_max, bucket_frames(int(n_marks.max())))
    mag, real, imag, _f0, _sh = lossless.analysis_core_batch(
        t_sig, marks[:, :F], n_marks, t_nsig, flags[:, :F], fft_len=4096,
        fs=FS)
    out = lossless.synthesis_core_batch(mag, real, imag, marks[:, :F],
                                        n_marks, fft_len=4096, out_len_max=S)
    out = out.cpu().numpy()
    del mag, real, imag
    worst = _p99_vs_input([out[b, :len(s)] for b, s in enumerate(a_sigs)],
                          a_sigs, "tracked lossless witness")
    log(f"[analysis] tracked lossless witness, {len(a_sigs)} x "
        f"{UTT_SECONDS} s: worst p99 |syn - sig| {worst:.3g} (< 2^-15)")

    # the analysis requests: counts from 0 just before, read just after
    K.reset_launch_counts()
    K4.reset_launch_counts()
    fallbacks = ab.capacity_fallbacks
    audio = {}
    for n in ANALYSIS_SIZES:
        req = [a_sigs[i % len(a_sigs)] for i in range(n)]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ab.analysis_compressed_batch(req, FS, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for i, (mml, mrm, mim, lf0, shift) in enumerate(res):
            nf = len(shift)
            if not (nf > 0 and mml.shape == (nf, MAG_DIM)
                    and mrm.shape == mim.shape == (nf, PHASE_DIM)
                    and lf0.shape == (nf,)):
                raise AssertionError(f"analysis request {n}, utt {i}: shapes "
                                     f"{mml.shape} {mrm.shape} {lf0.shape}")
            if not all(np.all(np.isfinite(x)) for x in (mml, mrm, mim, lf0)):
                raise AssertionError(f"analysis request {n}, utt {i}: "
                                     "non-finite features")
        audio[n] = sum(len(x) for x in req) / FS
        log(f"[analysis] request of {n} utts ({audio[n]:.1f} audio-s): "
            f"{dt * 1000:.1f} ms wall, {audio[n] / dt:.1f} audio-s/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (first "
            "call)")
    counts = {**K.launch_counts(), **K4.launch_counts()}
    log(f"[analysis] launches during the analysis path: {counts}; capacity "
        f"fallbacks {ab.capacity_fallbacks - fallbacks}")
    for name in ("frames", "walk"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "analysis path")
    if ab.capacity_fallbacks != fallbacks:
        raise AssertionError("the device walk hit its capacity on the "
                             "analysis path")

    for n in ANALYSIS_SIZES:
        req = [a_sigs[i % len(a_sigs)] for i in range(n)]
        walls = []
        for _ in range(WARM_RUNS_ANALYSIS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ab.analysis_compressed_batch(req, FS, device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        log(f"[analysis] warm request of {n} utts, {WARM_RUNS_ANALYSIS} runs: "
            f"median {med * 1000:.1f} ms (min {min(walls) * 1000:.1f}, max "
            f"{max(walls) * 1000:.1f}), {audio[n] / med:.1f} audio-s/s at the "
            "median (features on the host)")

    # the two phases of one 32-utterance group, and the Viterbi loop inside
    # phase 1, timed by CUDA events on the stream
    alpha = 0.77
    ckw = dict(mag_dim=MAG_DIM, phase_dim=PHASE_DIM, alpha=alpha,
               alpha_phase=alpha,
               mag_dim_ph=get_num_full_mel_coeffs_from_num_phase_coeffs(
                   5000.0, PHASE_DIM, alpha, FS))
    p1 = cuda_ms(lambda: ab._track_place_impl(
        t_sig, t_nsig, t_nfrm, fs=FS, n_frames_max=Tmax, m_max=m_max),
        reps=3, warmup=1)
    p2 = cuda_ms(lambda: ab._analyze_compress_impl(
        t_sig, marks, flags, n_marks, t_nsig, fs=FS, fft_len=4096, F=F,
        feats_f16=True, **ckw), reps=3, warmup=1)
    fs_a = tracker.analysis_rate(FS)[0]
    xa, _ = tracker._preprocess(t_sig, fs=FS)
    nccf, valid = tracker._nccf(xa, t_nfrm, n_frames_max=Tmax, fs_a=fs_a)
    vals, lags = tracker._candidates(nccf)
    vit = cuda_ms(lambda: tracker._viterbi(vals, lags, valid, fs_a=fs_a),
                  reps=3, warmup=1)
    log(f"[analysis] one group of {len(a_sigs)} utts on the stream: phase 1 "
        f"(track + K4) {p1:.3f} ms, of which the Viterbi loop {vit:.3f} ms "
        f"({vit / p1:.3f}); phase 2 (K1 + rfft + mel compression, F={F}) "
        f"{p2:.3f} ms")

    # the card against the CPU on the 8-utterance request, float32 output
    req = a_sigs[:8]
    t0 = time.perf_counter()
    cpu = ab.analysis_compressed_batch(req, FS, feat_dtype=np.float32,
                                       device="cpu")
    dt_cpu = time.perf_counter() - t0
    gpu = ab.analysis_compressed_batch(req, FS, feat_dtype=np.float32,
                                       device=dev)
    n_diff, n_all, s_err, l_err = 0, 0, 0.0, 0.0
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        if len(g[4]) != len(c[4]):
            raise AssertionError(f"CUDA vs CPU, utt {i}: {len(g[4])} marks "
                                 f"against {len(c[4])}")
        pm_g, pm_c = np.cumsum(g[4]), np.cumsum(c[4])
        d = np.abs(pm_g - pm_c)
        if d.max() > 1:
            raise AssertionError(f"CUDA vs CPU, utt {i}: a mark moved by "
                                 f"{d.max()} samples")
        n_diff += int(np.sum(d > 0))
        n_all += len(d)
        ok = agreeing_frames(pm_g, pm_c)
        s_err = max([s_err] + [float(np.abs(g[k][ok] - c[k][ok]).max())
                               for k in range(3)])
        l_err = max(l_err, float(np.max(np.abs(g[3][ok] - c[3][ok])
                                        / np.abs(c[3][ok]))))
    log(f"[analysis] CUDA vs CPU, 8 utts: {n_diff} of {n_all} marks differ "
        f"(by 1 sample; bound {MAX_MARK_DIFF_SHARE} of them); on agreeing "
        f"frames max |diff| {s_err:.3g} on the mel streams (bound "
        f"{TOL_ANALYSIS_STREAMS}), {l_err:.3g} relative on lf0 (bound "
        f"{TOL_ANALYSIS_LF0_REL}); CPU took {dt_cpu * 1000:.1f} ms")
    if n_diff > MAX_MARK_DIFF_SHARE * n_all:
        raise AssertionError(f"CUDA vs CPU: {n_diff} of {n_all} marks differ")
    if not (s_err <= TOL_ANALYSIS_STREAMS and l_err <= TOL_ANALYSIS_LF0_REL):
        raise AssertionError("CUDA vs CPU analysis features out of bounds")
    return counts


# ---------------------------------------------------------------------------
# K5, the real DFT (a radix-16 FFT), and the lossless copy-synthesis path

def dft_work(rows: int, n: int) -> tuple[int, float]:
    """(bytes, float32 operations) that a real DFT of ``rows`` rows of
    length n needs: the row read once and the two h = n/2+1 bin planes
    written once (the inverse the other way round), and an FFT's 2.5 n
    log2 n operations per row (half the 5 n log2 n of a complex FFT)."""
    h = n // 2 + 1
    return rows * (n + 2 * h) * 4, rows * 2.5 * n * np.log2(n)


def dft_shares(r: dict, rows_tensor) -> str:
    """The share of the bound K5 reached (bound_ms / ms), its time over
    cuFFT's, and, as the card's practical rate for the same bytes, the
    time of a device copy of the (rows, n) side (``clone``)."""
    copy_ms = cuda_ms(rows_tensor.clone)
    return (f"{r['bound_ms'] / r['ms']:.1%} of the {r['bound_by']} bound, "
            f"{r['ms'] / r['library_ms']:.3f}x cuFFT's time; a copy of the "
            f"rows takes {copy_ms:.4f} ms ({r['bound_ms'] / copy_ms:.1%})")


def check_rfft(x, what: str, got=None) -> dict:
    """K5a on x (rows, n) against its plain version on the same rows, at
    1e-5 of the spectrum's peak, timed beside cuFFT's torch.fft.rfft (the
    yardstick; the port never calls it in K5's place).  ``got`` is the
    kernel's output where the caller already launched it."""
    from magphase_tpu_torch.kernels import dft as K5
    rows, n = x.shape
    if got is None:
        got = K5.rfft_fused(x, n)
    ref = K5.rfft_fused_plain(x, n)
    torch.cuda.synchronize()
    peak = max(float(r.abs().max()) for r in ref)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    if not err <= TOL_RFFT_REL * peak:
        raise AssertionError(f"K5a rfft_fused {what}: max |kernel - plain| "
                             f"{err:.3g} > {TOL_RFFT_REL} x peak {peak:.3g}")
    del got, ref
    bnd = bound(*dft_work(rows, n))
    r = dict(max_abs_err=err, ms=cuda_ms(lambda: K5.rfft_fused(x, n)),
             plain_ms=cuda_ms(lambda: K5.rfft_fused_plain(x, n), reps=3),
             bound_ms=bnd[0], bound_by=bnd[1],
             library_ms=cuda_ms(lambda: torch.fft.rfft(x)))
    log(f"[kernels] K5a rfft_fused {what}, rows={rows} n={n}: max_abs_err "
        f"{err:.3g} ({err / peak:.3g} of the peak) kernel {r['ms']:.4f} ms "
        f"plain {r['plain_ms']:.4f} ms cuFFT rfft {r['library_ms']:.4f} ms "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
        f"{dft_shares(r, x)}")
    return r


def check_irfft(zr, zi, what: str, got=None) -> dict:
    """K5b on the bin planes (rows, h) against its plain version on the
    same planes, at 1e-6 absolute, timed beside cuFFT's torch.fft.irfft.
    ``got`` is the kernel's output where the caller already launched it."""
    from magphase_tpu_torch.kernels import dft as K5
    rows, h = zr.shape
    n = 2 * (h - 1)
    if got is None:
        got = K5.irfft_fused(zr, zi, n)
    ref = K5.irfft_fused_plain(zr, zi, n)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= TOL_IRFFT_ABS:
        raise AssertionError(f"K5b irfft_fused {what}: max |kernel - plain| "
                             f"{err:.3g} > {TOL_IRFFT_ABS}")
    del ref
    z = torch.complex(zr, zi)
    bnd = bound(*dft_work(rows, n))
    r = dict(max_abs_err=err, ms=cuda_ms(lambda: K5.irfft_fused(zr, zi, n)),
             plain_ms=cuda_ms(lambda: K5.irfft_fused_plain(zr, zi, n),
                              reps=3),
             bound_ms=bnd[0], bound_by=bnd[1],
             library_ms=cuda_ms(lambda: torch.fft.irfft(z, n=n)))
    log(f"[kernels] K5b irfft_fused {what}, rows={rows} n={n}: max_abs_err "
        f"{err:.3g} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
        f"cuFFT irfft {r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); {dft_shares(r, got)}")
    return r


def check_dft_at_group_shapes(dev, frames, inv_rows: int, inv_n: int,
                              seed: int) -> None:
    """K5 at the shapes of a whole group, beside the witness's own: the
    forward on the K1 frames of one analysis group, the inverse on
    unit-scale bins at the serving geometry."""
    check_rfft(frames.reshape(-1, frames.shape[-1]), "on one analysis group")
    h = inv_n // 2 + 1
    gen = torch.Generator(dev).manual_seed(seed)
    zr = torch.randn(inv_rows, h, device=dev, generator=gen)
    zi = torch.randn(inv_rows, h, device=dev, generator=gen)
    check_irfft(zr, zi, "at the serving geometry")


def run_k5_witness(sigs, w_args, S: int) -> tuple[dict, dict]:
    """The lossless witness with K5 in place of cuFFT, launch counts from
    0: the exact-mark witness signals through K1, K5a, the lossless
    features, the synthesis spectrum, K5b and K2; every utterance held at
    p99 < 2^-15.  Then K5a and K5b held against their plain versions on
    the very inputs this path gave them, and timed.  Returns the launch
    counts and the two kernels' entries of the kernels line."""
    from magphase_tpu_torch.core import framing
    from magphase_tpu_torch.core.windows import HANNING
    from magphase_tpu_torch.kernels import dft as K5
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.vocoder import lossless
    n = 4096
    w_sig, w_pm, w_nfrms, w_nsig = w_args
    K.reset_launch_counts()
    K5.reset_launch_counts()
    frames = framing.pitch_sync_frames_batch(w_sig, w_pm, w_nfrms, w_nsig,
                                             n, win_family=HANNING)[0]
    re, im = K5.rfft_fused(frames, n)
    spec = lossless.synthesis_spectrum(*lossless.lossless_features(
        torch.complex(re, im)))
    zr, zi = spec.real.contiguous(), spec.imag.contiguous()
    del spec
    m_frm = K5.irfft_fused(zr, zi, n)
    out = framing.ola_centered_batch(m_frm, w_pm, w_nfrms, S).cpu().numpy()
    counts = {**K.launch_counts(), **K5.launch_counts()}
    for name in ("frames", "ola", "rfft_fused", "irfft_fused"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the K5 "
                                 "lossless witness")
    worst = _p99_vs_input([out[b, :len(s)] for b, s in enumerate(sigs)],
                          sigs, "K5 lossless witness")
    log(f"[k5] lossless witness through K1 -> K5a -> K5b -> K2, {len(sigs)} x "
        f"{UTT_SECONDS} s, fft {n}: worst p99 |syn - sig| {worst:.3g} "
        f"(< 2^-15); launches {counts}")
    h = n // 2 + 1
    results = {
        "rfft_fused": check_rfft(frames.reshape(-1, n), "on the witness",
                                 got=(re.reshape(-1, h), im.reshape(-1, h))),
        "irfft_fused": check_irfft(zr.reshape(-1, h), zi.reshape(-1, h),
                                   "on the witness",
                                   got=m_frm.reshape(-1, n))}
    return counts, results


def _p99_vs_input(outs, req, what: str) -> float:
    """Worst p99 |out - in| away from the edges over a request; raises on a
    wrong length, a non-finite or silent output or a p99 of one PCM16 step
    or more."""
    worst = 0.0
    for i, (o, sig) in enumerate(zip(outs, req)):
        n = len(sig)
        if len(o) != n or not np.all(np.isfinite(o)):
            raise AssertionError(f"{what}, utt {i}: length {len(o)} != {n} "
                                 "or non-finite samples")
        if not np.std(o) > 1e-4:
            raise AssertionError(f"{what}, utt {i}: silent output")
        p99 = float(np.percentile(np.abs(o[2000:n - 2000]
                                         - sig[2000:n - 2000]), 99))
        if not p99 < TOL_LOSSLESS_P99:
            raise AssertionError(f"{what}, utt {i}: p99 |out - in| {p99:.3g}")
        worst = max(worst, p99)
    return worst


def run_copy_synthesis_path(dev, a_sigs, sigs, marks, vois, group, Tmax,
                            m_max, S) -> dict:
    """Path 4, lossless copy-synthesis: copy_synthesis_batch requests with
    the launch counts from 0 (returned), each output held to its input,
    warm timings, the phase split of one group, the card against the CPU
    on 8 utterances, and analysis_lossless_batch from given epochs on the
    card against the CPU."""
    from magphase_tpu_torch.epochs import placement_device as pd
    from magphase_tpu_torch.kernels import dft as K5
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.kernels import walk as K4
    from magphase_tpu_torch.parallel import analysis_batch as ab
    from magphase_tpu_torch.parallel import copy_synthesis as cs
    from magphase_tpu_torch.utils.padding import bucket_frames
    from magphase_tpu_torch.vocoder import lossless

    K.reset_launch_counts()
    K4.reset_launch_counts()
    K5.reset_launch_counts()
    audio, first = {}, {}
    for n in COPY_SIZES:
        req = [a_sigs[i % len(a_sigs)] for i in range(n)]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = cs.copy_synthesis_batch(req, FS, device=dev)
        dt = time.perf_counter() - t0
        worst = _p99_vs_input(outs, req, f"copy-synthesis request {n}")
        audio[n] = sum(len(x) for x in req) / FS
        first[n] = outs
        log(f"[copy] request of {n} utts ({audio[n]:.1f} audio-s): "
            f"{dt * 1000:.1f} ms wall, {audio[n] / dt:.1f} audio-s/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (first "
            f"call); worst p99 |out - in| {worst:.3g} (< 2^-15)")
    counts = {**K.launch_counts(), **K4.launch_counts(),
              **K5.launch_counts()}
    log(f"[copy] launches during the copy-synthesis path: {counts}")
    for name in ("frames", "ola", "walk"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "copy-synthesis path")

    for n in COPY_SIZES:
        req = [a_sigs[i % len(a_sigs)] for i in range(n)]
        walls = []
        for _ in range(WARM_RUNS_COPY):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.copy_synthesis_batch(req, FS, device=dev)
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        log(f"[copy] warm request of {n} utts, {WARM_RUNS_COPY} runs: median "
            f"{med * 1000:.1f} ms (min {min(walls) * 1000:.1f}, max "
            f"{max(walls) * 1000:.1f}), {audio[n] / med:.1f} audio-s/s at the "
            "median (waveforms on the host)")

    # where one group of 32 spends its time on the stream: phase 1 (tracker
    # + K4), the analysis (K1 + rfft) and the synthesis (irfft + K2)
    t_sig, t_nsig, t_nfrm = group
    mk, fl, nm = ab._track_place_impl(t_sig, t_nsig, t_nfrm, fs=FS,
                                      n_frames_max=Tmax, m_max=m_max)
    F = min(m_max, bucket_frames(int(nm.max())))
    mk, fl = mk[:, :F], fl[:, :F]
    p1 = cuda_ms(lambda: ab._track_place_impl(
        t_sig, t_nsig, t_nfrm, fs=FS, n_frames_max=Tmax, m_max=m_max),
        reps=3, warmup=1)
    an = cuda_ms(lambda: lossless.analysis_core_batch(
        t_sig, mk, nm, t_nsig, fl, fft_len=4096, fs=FS), reps=3, warmup=1)
    mag, real, imag, _f0, _sh = lossless.analysis_core_batch(
        t_sig, mk, nm, t_nsig, fl, fft_len=4096, fs=FS)
    sy = cuda_ms(lambda: lossless.synthesis_core_batch(
        mag, real, imag, mk, nm, fft_len=4096, out_len_max=S + (1 << 14)),
        reps=3, warmup=1)
    del mag, real, imag
    log(f"[copy] one group of {t_sig.shape[0]} utts on the stream: phase 1 "
        f"(track + K4) {p1:.3f} ms, analysis (K1 + rfft, F={F}) {an:.3f} ms, "
        f"synthesis (irfft + K2) {sy:.3f} ms")

    # the card against the CPU on the smaller request, on the utterances
    # whose marks agree
    n_cmp = min(COPY_SIZES)
    req = [a_sigs[i % len(a_sigs)] for i in range(n_cmp)]
    t0 = time.perf_counter()
    cpu = cs.copy_synthesis_batch(req, FS, device="cpu")
    dt_cpu = time.perf_counter() - t0
    _, host8, _, Tmax8, m_max8, _ = ab._host_signal_batch(req, FS, 4096)
    mk_d, mk_c = (pd.track_and_place_batch(
        *(torch.from_numpy(a).to(d) for a in host8), fs=FS,
        n_frames_max=Tmax8, m_max=m_max8) for d in (dev, "cpu"))
    n_same, rel = 0, 0.0
    for b, (g, c) in enumerate(zip(first[n_cmp], cpu)):
        nb = int(mk_c[2][b])
        if int(mk_d[2][b]) != nb or not torch.equal(
                mk_d[0][b, :nb].cpu(), mk_c[0][b, :nb]):
            continue
        n_same += 1
        rel = max(rel, float(np.abs(g - c).max() / np.abs(c).max()))
    log(f"[copy] CUDA vs CPU, {n_cmp} utts: marks agree on {n_same}; there "
        f"max |diff|/peak {rel:.3g} (bound {TOL_CUDA_VS_CPU}); CPU took "
        f"{dt_cpu * 1000:.1f} ms")
    if n_same == 0 or not rel <= TOL_CUDA_VS_CPU:
        raise AssertionError("CUDA vs CPU copy-synthesis out of bounds")

    # analysis_lossless_batch from the witness's exact epochs, card vs CPU
    eps = [(np.asarray(m) / FS, v) for m, v in zip(marks, vois)]
    got = ab.analysis_lossless_batch(sigs, FS, epochs=eps, device=dev)
    ref = ab.analysis_lossless_batch(sigs, FS, epochs=eps, device="cpu")
    m_err, p_err = 0.0, 0.0
    for g, r in zip(got, ref):
        if not (np.array_equal(g[4], r[4]) and np.array_equal(g[3], r[3])):
            raise AssertionError("analysis_lossless_batch: shift or f0 differ"
                                 " between the card and the CPU")
        peak = float(np.abs(r[0]).max())
        m_err = max(m_err, float(np.abs(g[0] - r[0]).max()) / peak)
        big = r[0] > 1e-3 * peak
        p_err = max(p_err, max(float(np.abs(g[i][big] - r[i][big]).max())
                               for i in (1, 2)))
    log(f"[copy] analysis_lossless_batch from given epochs, {len(sigs)} "
        f"utts, CUDA vs CPU: shift and f0 equal; mag {m_err:.3g} of the peak"
        f" (bound {TOL_LOSSLESS_MAG_REL}), phasor {p_err:.3g} where mag > "
        f"1e-3 of the peak (bound {TOL_LOSSLESS_PHASOR})")
    if not (m_err <= TOL_LOSSLESS_MAG_REL and p_err <= TOL_LOSSLESS_PHASOR):
        raise AssertionError("CUDA vs CPU lossless features out of bounds")
    return counts


def profile_copy_synthesis(a_sigs, dev) -> None:
    """Where the time of one warm 192-utterance copy-synthesis request
    goes (profile_call)."""
    from magphase_tpu_torch.parallel import copy_synthesis as cs
    req = [a_sigs[i % len(a_sigs)] for i in range(max(COPY_SIZES))]
    profile_call(f"copy-synthesis request of {len(req)} utts",
                 lambda: cs.copy_synthesis_batch(req, FS, device=dev))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="profile one warm 128-utterance serving request, "
                    "one warm 192-utterance analysis request and one warm "
                    "192-utterance copy-synthesis request")
    args = ap.parse_args()

    # phase 1 — environment
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke run needs a CUDA card and does not run on the CPU")
    from magphase_tpu_torch.kernels import _build
    from magphase_tpu_torch.kernels import dft as K5
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.kernels import walk as K4

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()} "
        f"nvcc {_build.find_nvcc()}")
    log(f"[env] nvidia-smi: {smi}")
    log(f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # phase 2 — build, one nvcc per source, started together
    t0 = time.perf_counter()
    infos = _build.build(K.SOURCE, K4.SOURCE, K5.SOURCE)
    for name, info in infos.items():
        log(f"[build] {name}: {info['path']} in {info['seconds']:.2f} s "
            f"(cached={info['cached']}); ptxas: "
            f"{' | '.join(ptxas_report(info['log']))}")
    for n_ in (4096, 2048):
        for inv in (False, True):
            log(f"[build] K5 {'irfft' if inv else 'rfft'} n={n_}: "
                f"{K5.kernel_occupancy(n_, inv)}")
    log(f"[build] {len(infos)} sources in {time.perf_counter() - t0:.2f} s "
        "wall")

    from magphase_tpu_torch.core import framing
    from magphase_tpu_torch.core.windows import HANNING
    from magphase_tpu_torch.epochs import placement_device as pd
    from magphase_tpu_torch.parallel import analysis_batch as ab
    from magphase_tpu_torch.parallel import batch
    from magphase_tpu_torch.utils.padding import (FRM_STEP, bucket,
                                                  bucket_frames,
                                                  bucket_signal)
    from magphase_tpu_torch.vocoder import lossless

    rng = np.random.default_rng(args.seed)
    sigs, marks, vois = make_witness_signals(rng, 16, UTT_SECONDS)
    n_max = max(REQUEST_SIZES)
    feats = [make_features(rng, UTT_SECONDS) for _ in range(n_max)]
    keys_all = rng.integers(0, 2 ** 32, (n_max, 2), dtype=np.uint32)
    a_sigs, a_marks, a_vois = make_witness_signals(rng, ANALYSIS_DISTINCT,
                                                   UTT_SECONDS)
    results = {}

    # phase 3 — each kernel against its plain version at main-path shapes
    B = len(sigs)
    S = bucket_signal(max(len(s) for s in sigs))
    F = bucket(max(len(m) for m in marks), FRM_STEP)
    sig_np = np.zeros((B, S), np.float32)
    pm_np = np.zeros((B, F), np.int32)
    voi_np = np.zeros((B, F), np.float32)
    for b in range(B):
        sig_np[b, :len(sigs[b])] = sigs[b]
        pm_np[b, :len(marks[b])] = marks[b]
        voi_np[b, :len(vois[b])] = vois[b]
    w_sig = torch.from_numpy(sig_np).to(dev)
    w_pm = torch.from_numpy(pm_np).to(dev)
    w_voi = torch.from_numpy(voi_np).to(dev)
    w_nfrms = torch.tensor([len(m) for m in marks], dtype=torch.int32,
                           device=dev)
    w_nsig = torch.tensor([len(s) for s in sigs], dtype=torch.int32,
                          device=dev)
    _, L, R, _ = framing.frame_geometry_batch(w_pm, w_nfrms, w_nsig)
    k1_args = (w_sig, w_pm, L.to(torch.int32).contiguous(),
               R.to(torch.int32).contiguous(), w_voi, w_nfrms, w_nsig)
    k1_kw = dict(fft_len=4096, fam_voiced=0, fam_unvoiced=0)
    got = K.frames(*k1_args, **k1_kw)
    ref = K.frames_plain(*k1_args, **k1_kw)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= TOL_FRAMES:
        raise AssertionError(f"K1 frames: max |kernel - plain| {err:.3g} > "
                             f"{TOL_FRAMES}")
    # bytes: every input once, the (B, F, N) output once; operations: the
    # window (a division, a compare, cos or sqrt and a scale) and the
    # multiply, 5 per output element
    bnd = bound(nbytes(*k1_args, got), 5 * got.numel())
    results["frames"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: K.frames(*k1_args, **k1_kw)),
        plain_ms=cuda_ms(lambda: K.frames_plain(*k1_args, **k1_kw), reps=3),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
    # the card's practical rate for the same stores: a fill of the output
    shape = tuple(got.shape)
    del got, ref
    fill_ms = cuda_ms(lambda: torch.zeros(shape, device=dev))
    r = results["frames"]
    log(f"[kernels] K1 frames B={B} F={F} N=4096 S={S}: max_abs_err {err:.3g} "
        f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}); "
        f"{r['bound_ms'] / r['ms']:.1%} of the bound; a torch.zeros of the "
        f"output takes {fill_ms:.4f} ms ({r['bound_ms'] / fill_ms:.1%} of the "
        f"bound), the kernel {r['ms'] / fill_ms:.3f}x that")

    # K2/K3 at the geometry of the 128-utterance serving request
    utts128 = feats
    fft_syn, max_b = batch._synthesis_geometry(utts128, FS, 4096, False)
    host = batch._prepare_synthesis_group(
        utts128, n_real=len(utts128), keys=keys_all, max_b=max_b, fs=FS,
        mag_dim=MAG_DIM, phase_dim=PHASE_DIM)
    s_pm = torch.from_numpy(host["pm"]).to(dev)
    s_shifts = torch.from_numpy(host["shifts"]).to(dev)
    s_nfrms = torch.from_numpy(host["nfrms"]).to(dev)
    Bs, Fs_ = s_pm.shape
    frm = torch.randn(Bs, Fs_, fft_syn, device=dev,
                      generator=torch.Generator(dev).manual_seed(args.seed))
    starts = (s_pm - fft_syn // 2).to(torch.int32).contiguous()
    wl, wr = framing.ar_winlens(s_shifts, s_nfrms)
    wl = wl.to(torch.int32).contiguous()
    wr = wr.to(torch.int32).contiguous()
    O = host["O"]
    got = K.ola(frm, starts, s_nfrms, out_len=O)
    ref = K.ola_plain(frm, starts, s_nfrms, out_len=O)
    torch.cuda.synchronize()
    k2_err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError("K2 ola: kernel is not bitwise equal to plain "
                             f"(max diff {k2_err:.3g})")
    # the one torch call that computes the same sums (in another order):
    # scatter_add_ over flattened indices, invalid samples to a spare slot
    p_ = torch.arange(fft_syn, device=dev)
    o_idx = starts.to(torch.int64)[..., None] + p_
    keep = (o_idx >= 0) & (o_idx < O) & (
        torch.arange(Fs_, device=dev)[None, :, None] < s_nfrms[:, None, None])
    flat = (torch.arange(Bs, device=dev)[:, None, None] * (O + 1)
            + torch.where(keep, o_idx, O)).reshape(-1)
    frm_flat = frm.reshape(-1)
    del p_, o_idx, keep

    def ola_library():
        out = torch.zeros(Bs * (O + 1), device=dev)
        return out.scatter_add_(0, flat, frm_flat)

    # bytes: frames, starts and counts once, the (B, O) output once;
    # operations: one add per frame element
    bnd = bound(nbytes(frm, starts, s_nfrms, got), frm.numel())
    results["ola"] = dict(
        max_abs_err=k2_err,
        ms=cuda_ms(lambda: K.ola(frm, starts, s_nfrms, out_len=O)),
        plain_ms=cuda_ms(lambda: K.ola_plain(frm, starts, s_nfrms,
                                             out_len=O), reps=3),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=cuda_ms(ola_library, reps=5))
    del flat, frm_flat
    got = K.ola_anti_ring(frm, starts, s_nfrms, wl, wr, out_len=O)
    ref = K.ola_anti_ring_plain(frm, starts, s_nfrms, wl, wr, out_len=O)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= TOL_OLA_AR:
        raise AssertionError(f"K3 ola_anti_ring: max |kernel - plain| "
                             f"{err:.3g} > {TOL_OLA_AR}")
    # as K2, plus the window lengths read and the window per element (a
    # division, a compare, cos, a scale and the multiply): 6 operations
    bnd = bound(nbytes(frm, starts, s_nfrms, wl, wr, got), 6 * frm.numel())
    results["ola_anti_ring"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: K.ola_anti_ring(frm, starts, s_nfrms, wl, wr,
                                           out_len=O)),
        plain_ms=cuda_ms(lambda: K.ola_anti_ring_plain(
            frm, starts, s_nfrms, wl, wr, out_len=O), reps=3),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
    for name in ("ola", "ola_anti_ring"):
        r = results[name]
        lib = ("" if r["library_ms"] is None
               else f" scatter_add_ {r['library_ms']:.4f} ms")
        log(f"[kernels] {name} B={Bs} F={Fs_} N={fft_syn} O={O}: max_abs_err "
            f"{r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms{lib} bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    del got, ref

    # the anti-ringing window and the OLA as one pass (K3) or two (window,
    # then K2), timed at the entry of core/framing.py
    def ola_ar_fused():
        return framing.ola_centered_batch(frm, s_pm, s_nfrms, O,
                                          ar_shifts=s_shifts)

    def ola_ar_two_pass():
        return framing.ola_centered_batch(
            framing.apply_anti_ringing(frm, s_shifts, s_nfrms), s_pm,
            s_nfrms, O)

    log(f"[kernels] anti-ringing + OLA, B={Bs} F={Fs_} N={fft_syn}: fused "
        f"(K3) {cuda_ms(ola_ar_fused, reps=20):.4f} ms, two-pass (window + "
        f"K2) {cuda_ms(ola_ar_two_pass, reps=20):.4f} ms")

    # K4, the epoch walk, against its plain version on the walk inputs the
    # port's tracker gives for the 32 distinct analysis signals
    _, host_a, S_a, Tmax_a, m_max_a, _ = ab._host_signal_batch(
        a_sigs, FS, 4096)
    t_sig, t_nsig, t_nfrm = (torch.from_numpy(a).to(dev) for a in host_a)
    y_snap, f0_t, voi_t = (x.contiguous() for x in pd._track_one(
        t_sig, t_nfrm, fs=FS, n_frames_max=Tmax_a))
    k4_args = (y_snap, f0_t, voi_t, t_nsig, t_nfrm)
    fstep = pd._walk_frame_step(FS)
    k4_kw = dict(fs=FS, m_max=m_max_a, frame_step=fstep,
                 snap_w=pd._snap_win(FS))
    got = K4.walk(*k4_args, **k4_kw)
    ref = K4.walk_plain(*k4_args, **k4_kw)
    torch.cuda.synchronize()
    for g, r, what in zip(got, ref, ("marks", "flags", "n_marks")):
        if not torch.equal(g, r):
            raise AssertionError(f"K4 walk: {what} of the kernel differ from "
                                 "the plain version")
    k4_err = max(float((g.to(torch.float32) - r.to(torch.float32)).abs()
                       .max()) for g, r in zip(got, ref))
    samples, steps = walk_work(f0_t, t_nsig, t_nfrm, *got, fs=FS,
                               frame_step=fstep)
    n_max_marks = int(got[2].max())
    # bytes: the window samples the voiced steps read, two track values and
    # the counts per step, the outputs once; operations: a compare and a
    # select per window sample.  Neither binds a serial chain: the walk's
    # bound is the steps of the longest walk (its marks and the step that
    # ends it) times the probe's time per step of the dependent skeleton.
    bytes_bnd = bound(4 * samples + 8 * steps + nbytes(t_nsig, t_nfrm, *got),
                      2 * samples)
    chain_ns, chain_cycles = walk_chain_ns(dev, fstep, S_a)
    # the same skeleton with the IEEE division that a frame step that is
    # no integer takes (no path of this run does)
    chain_ns_fdiv, _ = walk_chain_ns(dev, fstep + 0.5, S_a)
    chain_ms = (n_max_marks + 1) * chain_ns * 1e-6
    bnd = (chain_ms, "chain") if chain_ms >= bytes_bnd[0] else bytes_bnd
    results["walk"] = dict(
        max_abs_err=k4_err, ms=cuda_ms(lambda: K4.walk(*k4_args, **k4_kw)),
        plain_ms=cuda_ms(lambda: K4.walk_plain(*k4_args, **k4_kw), reps=2,
                         warmup=1),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
        bytes_bound_ms=bytes_bnd[0], chain_ns_per_step=chain_ns)
    r = results["walk"]
    log(f"[kernels] K4 walk B={len(a_sigs)} S={S_a} T={Tmax_a} "
        f"m_max={m_max_a} snap_w={pd._snap_win(FS)}: bitwise equal to plain; "
        f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms; longest walk "
        f"{n_max_marks} marks, {r['ms'] * 1e3 / n_max_marks:.4f} us per step "
        f"of it; chain probe {chain_ns:.2f} ns, {chain_cycles:.2f} SM cycles "
        f"per step ({CHAIN_PROBE_STEPS} steps; {chain_ns_fdiv:.2f} ns with "
        f"the float division), bound {r['bound_ms']:.6f} ms "
        f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of it reached; "
        f"bytes bound {bytes_bnd[0]:.6f} ms ({bytes_bnd[1]}; {samples} window"
        f" samples, {steps} steps)")
    log(f"[kernels] K4 launch shape: ring {K4.ring_geometry(FS)}, "
        f"{K4.kernel_occupancy(FS, Tmax_a)}; chain probe SASS: "
        f"{probe_sass(infos['walk']['path'], _build.find_nvcc())}")

    # K5 against its plain version: the forward on the K1 frames of this
    # analysis group at its realised frame bucket, the inverse at the
    # 128-utterance serving geometry
    F_a = min(m_max_a, bucket_frames(n_max_marks))
    frames_a = framing.pitch_sync_frames_batch(
        t_sig, got[0][:, :F_a], got[2], t_nsig, 4096, win_family=HANNING)[0]
    del got, ref
    check_dft_at_group_shapes(dev, frames_a, Bs * Fs_, fft_syn, args.seed)
    del frames_a

    # path 1, serving: counts from 0, lossless round trip + serving requests
    K.reset_launch_counts()
    K4.reset_launch_counts()

    # phase 4 — lossless witness through K1 + K2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mag, real, imag, _f0, _shift = lossless.analysis_core_batch(
        w_sig, w_pm, w_nfrms, w_nsig, w_voi, fft_len=4096, fs=FS)
    out = lossless.synthesis_core_batch(mag, real, imag, w_pm, w_nfrms,
                                        fft_len=4096, out_len_max=S)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = out.cpu().numpy()
    del mag, real, imag
    worst = _p99_vs_input([out[b, :len(s)] for b, s in enumerate(sigs)],
                          sigs, "lossless witness")
    log(f"[lossless] B={B} {UTT_SECONDS} s signals, fft 4096: worst p99 "
        f"|syn - sig| {worst:.3g} (< 2^-15), {dt * 1000:.1f} ms")

    # the anti-ringing OLA entry, ola_centered_batch(ar_shifts=) (K3), at
    # the 128-utterance serving geometry, against the two-pass form that
    # serving runs (apply_anti_ringing, then K2)
    fused, two_pass = ola_ar_fused(), ola_ar_two_pass()
    torch.cuda.synchronize()
    ar_err = float((fused - two_pass).abs().max())
    if not ar_err <= TOL_OLA_AR:
        raise AssertionError(f"ola_centered_batch(ar_shifts=) differs from "
                             f"the two-pass form by {ar_err:.3g}")
    log(f"[ola] anti-ringing fused into the OLA (K3) vs two-pass (K2), "
        f"B={Bs}: max |diff| {ar_err:.3g}")
    del fused, two_pass, frm

    # phase 5 — serving requests
    timings = {}
    for n in REQUEST_SIZES:
        utts, keys = feats[:n], keys_all[:n]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = batch.synthesis_from_compressed_batch(
            utts, FS, pf_type="magphase", keys=keys, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for i, (u, w) in enumerate(zip(utts, wavs)):
            if len(w) != expected_out_len(u[3]):
                raise AssertionError(f"request {n}, utt {i}: length {len(w)}"
                                     f" != {expected_out_len(u[3])}")
            if not np.all(np.isfinite(w)):
                raise AssertionError(f"request {n}, utt {i}: non-finite")
            if not np.std(w) > 1e-4:
                raise AssertionError(f"request {n}, utt {i}: silent output")
        audio_s = sum(len(w) for w in wavs) / FS
        timings[n] = (dt, audio_s, torch.cuda.max_memory_allocated())
        log(f"[serve] request of {n} utts ({audio_s:.1f} audio-s): "
            f"{dt * 1000:.1f} ms wall, {audio_s / dt:.1f} audio-s/s, peak "
            f"{timings[n][2] / 2 ** 30:.3f} GiB (first call)")
        if n == 8:
            wavs8 = wavs
    counts = K.launch_counts()
    log(f"[serve] launches during the serving path: {counts}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "serving path")

    # the same 8-utterance request on the CPU (plain versions throughout)
    t0 = time.perf_counter()
    wavs8_cpu = batch.synthesis_from_compressed_batch(
        feats[:8], FS, pf_type="magphase", keys=keys_all[:8], device="cpu")
    dt_cpu = time.perf_counter() - t0
    peak = max(float(np.abs(w).max()) for w in wavs8_cpu)
    rel = max(float(np.abs(a - b).max()) for a, b in zip(wavs8, wavs8_cpu)) \
        / peak
    if not rel <= TOL_CUDA_VS_CPU:
        raise AssertionError(f"CUDA vs CPU request: max|diff|/peak {rel:.3g}"
                             f" > {TOL_CUDA_VS_CPU}")
    log(f"[serve] CUDA vs CPU, 8 utts: max|diff|/peak {rel:.3g} "
        f"(bound {TOL_CUDA_VS_CPU}); CPU took {dt_cpu * 1000:.1f} ms")

    # warm timings of the three requests
    for n in REQUEST_SIZES:
        walls = []
        for _ in range(WARM_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch.synthesis_from_compressed_batch(
                feats[:n], FS, pf_type="magphase", keys=keys_all[:n],
                device=dev, block_result=False)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        audio_s = timings[n][1]
        log(f"[serve] warm request of {n} utts, {WARM_RUNS} runs: median "
            f"{med * 1000:.1f} ms (min {min(walls) * 1000:.1f}, max "
            f"{max(walls) * 1000:.1f}), {audio_s / med:.1f} audio-s/s at the "
            "median (device buffers, no download)")

    counts_k5, k5_results = run_k5_witness(
        sigs, (w_sig, w_pm, w_nfrms, w_nsig), S)
    results.update(k5_results)
    counts_a = run_analysis_path(dev, a_sigs, a_marks, a_vois,
                                 (t_sig, t_nsig, t_nfrm), Tmax_a, m_max_a,
                                 S_a)
    run_copy_synthesis_path(dev, a_sigs, sigs, marks, vois,
                            (t_sig, t_nsig, t_nfrm), Tmax_a, m_max_a, S_a)

    if args.profile:
        profile_request(feats, keys_all, dev)
        profile_analysis(a_sigs, dev)
        profile_copy_synthesis(a_sigs, dev)

    launches = {**counts, "walk": counts_a["walk"],
                "rfft_fused": counts_k5["rfft_fused"],
                "irfft_fused": counts_k5["irfft_fused"]}
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    **{k: r[k] for k in ("bytes_bound_ms",
                                         "chain_ns_per_step") if k in r})
               for name, r in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
