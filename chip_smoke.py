"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Builds the CUDA kernels from magphase_tpu_torch/csrc (framing.cu: K1-K3,
walk.cu: K4, dft.cu: K5, viterbi.cu: the tracker's Viterbi pass; one nvcc
per source, started together), checks
each against its plain torch version at the shapes its path gives it (K1
beside a device fill of its output; K2 also at one copy-synthesis group's
geometry, K2 and K3 with a bound over their valid frames alone and, for
comparison with earlier rows, the bound of the padded frame array; K3 beside the same call with one-sample windows and its SASS count per
windowed element; K4 beside the chain probe that gives the walk's own
bound; the Viterbi kernel bitwise on the DP inputs of the 32 analysis
signals, of one budget group of the analysis cell, of inputs full of ties
and of one 60 s utterance, beside its own chain probe), then
drives the port's paths, each with the launch counts set to 0 just before
it and read just after:

- serving: the lossless analysis/synthesis round trip on synthetic
  voiced/unvoiced signals (K1 + K2), the anti-ringing overlap-add entry
  ola_centered_batch(ar_shifts=) (K3) against the two-pass form, and three
  requests of batched compressed synthesis (1, 8 and 128 utterances of
  ~3 s at 48 kHz, 60/45 feature dims; K2), then (counts read) the
  8-utterance request with its noise keys derived from key= against the
  same keys given as keys=;
- wav-in compressed analysis: analysis_compressed_batch requests of 8 and
  192 utterances of 3 s at 48 kHz (fft_len 4096, 60/45 dims, tracked
  epochs; the Viterbi kernel and K4 in phase 1, K1 in phase 2), after a
  tracked lossless witness
  (tracker + K4 marks -> K1 -> K2), with the card against the CPU on the
  8-utterance request;
- the K5 lossless witness: the 16 exact-mark witness signals through K1,
  the fused forward DFT (K5a), the lossless features, the fused inverse
  DFT (K5b) and K2 (K5 is on no production path, as in the JAX package);
- lossless copy-synthesis: copy_synthesis_batch requests of 8 and 192
  utterances of 3 s (tracker + K4, K1 + rfft, irfft + K2), each output
  held to its input, the phase split of one group, the card against the
  CPU on 8 utterances, and analysis_lossless_batch from given epochs on
  the card against the CPU;
- the MagPhaseVocoder facade (the README quickstart) on 4 wavs of 3 s:
  analyze -> synthesize, the same at the constant frame rate, the
  filter-bank warp, and analyze_batch(b_const_rate=True) (K1, K2, K4),
  with K1, K2 and K4 held to their plain versions on the inputs this path
  gave them, the card against the CPU (each mark that moved logged with
  both devices' snap signal there), batch == single, and wall times;
- the corpus CLI (python -m magphase_tpu_torch.cli) on 64 wavs of
  2.5-3 s (run_cli_path): extract --batch-size 32 with one unreadable wav
  on the crash list (K4, K1), generate --batch-size 16 (pipelined, PCM16;
  K2), at batch size 5, through the fallback runner and with the int8
  transport, the constant frame rate, convert-labels, eval, and a serve
  daemon with two generate --server requests; K1, K2 and K4 held to their
  plain versions on the CLI's own calls, byte-identical wavs across the
  runners, batch sizes and requests, no hidden fallback, card against
  CPU, and wall time, audio-s/s and peak memory per command;
- the variant vocoders (run_variants_path) on 4 wavs of 3 s at 48 kHz,
  fft_len 4096, 60/45 dims: type1 analysis (variable and 5 ms rate) into
  type1 synthesis ('magphase', 'min_phase', constant rate), type2
  analysis (with and without b_norm_mag) into type2 synthesis, phase-comp
  analysis into phase-comp synthesis, the type1-old synthesis (and its
  'det' and 'whole' Griffin-Lim forms), griffin_lim on lossless
  magnitudes for each phase_init (K1 with per-frame VOI_NOISE / HANNING
  windows, K2); K1 and K2 held to their plain versions on the path's own
  calls, card against CPU on the first wav, cold and warm wall ms and
  peak memory per entry; then one 128-utterance serving request under
  MAGPHASE_HPF_MODE=blocked, byte-identical across two batch
  compositions, and extract_epochs under MAGPHASE_TRACKER_WHITEN=clip30
  and cube, card against CPU;
- then the data mesh, two worker processes and the serving example, and
  last the benchmark (run_bench_phase): bench_torch/run.py in a process
  of its own, both cells at one timed request with every check and
  control, each of its lines required to say correct: true.

Each kernel's time, and its library call's where it has one, is the
median of 30 calls, each between CUDA events of its own, all enqueued
behind a device-side wait so that the host's launch rate cannot reach
them (kernel_ms), with the L2 flushed before each call (cold) and not
(warm), beside the mean of 10 back-to-back calls between two events
(cuda_ms).  The mesh phase fails where the peak memory of a
2-logical-shard analysis or copy-synthesis request is not within 10% of
the same request with mesh=None.

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
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# the synthetic inputs, the card-vs-CPU checks and their bounds, shared
# with the benchmark (bench_torch/run.py)
from bench_torch.inputs import (FS, MAG_DIM, MAX_MARK_DIFF_SHARE, PHASE_DIM,
                                TOL_ANALYSIS_LF0_REL, TOL_ANALYSIS_STREAMS,
                                TOL_CUDA_VS_CPU, agreeing_frames,
                                analysis_vs_cpu, busy_us, expected_out_len,
                                make_features, make_witness_signals,
                                p99_vs_input, serving_vs_cpu)
from bench_torch.layers import kernel_label
from bench_torch.run import CELLS as BENCH_CELLS
from bench_torch.run import POOL_SECONDS as BENCH_POOL_SECONDS
from bench_torch.run import nvidia_smi

UTT_SECONDS = 3.0
REQUEST_SIZES = (1, 8, 128)
ANALYSIS_SIZES = (8, 192)
ANALYSIS_DISTINCT = 32      # distinct signals, cycled as bench.py:327 does
CSRC = "magphase_tpu_torch/csrc"
PALLAS = "magphase_tpu/pallas_kernels"
SOURCES = {"frames": f"{CSRC}/framing.cu", "ola": f"{CSRC}/framing.cu",
           "ola_anti_ring": f"{CSRC}/framing.cu", "walk": f"{CSRC}/walk.cu",
           "rfft_fused": f"{CSRC}/dft.cu", "irfft_fused": f"{CSRC}/dft.cu",
           "viterbi": f"{CSRC}/viterbi.cu"}
REPLACES = {"frames": f"{PALLAS}/framing_pallas.py:56",
            "ola": f"{PALLAS}/framing_pallas.py:241",
            "ola_anti_ring": f"{PALLAS}/framing_pallas.py:246",
            "walk": f"{PALLAS}/walk_pallas.py:51",
            "rfft_fused": "tools/dft_pallas.py:139",
            "irfft_fused": "tools/dft_pallas.py:148",
            # no Pallas kernel: the JAX package's lax.scan of the DP
            "viterbi": "magphase_tpu/epochs/tracker.py:277"}
# the card's peaks (NVIDIA's H100 SXM data sheet, dense float32, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K1 and K3 may differ from their plain versions by float32 round-off
# (both are written to round every operation as the plain version does,
# but the window's cosf is the only libm call); K2 must be bitwise equal.
TOL_FRAMES = 1e-6
TOL_OLA_AR = 1e-6
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
# the Viterbi kernel's inputs beside the 32 analysis signals: one budget
# group of the analysis cell (24 utterances of its pool's longest, 3.5 s;
# bench_torch/run.py POOL_SECONDS) and one utterance of 60 s
VITERBI_CELL_GROUP = 24
VITERBI_LONG_SECONDS = 60.0
# kernel_ms: calls per reading, and the read that evicts the card's L2
# (50 MB on an H100) before each call of a cold reading
KERNEL_CALLS = 30
FLUSH_BYTES = 256 << 20


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


_SLEEP_CYCLES = 20_000_000
_cycles_per_ms: list = []
_flush: list = []


def _sleep_cycles_per_ms() -> float:
    """SM clock cycles per ms of torch.cuda._sleep on this card: CUDA
    events around a sleep of _SLEEP_CYCLES cycles, measured once."""
    if not _cycles_per_ms:
        torch.cuda._sleep(_SLEEP_CYCLES // 20)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        torch.cuda._sleep(_SLEEP_CYCLES)
        end.record()
        end.synchronize()
        _cycles_per_ms.append(_SLEEP_CYCLES / start.elapsed_time(end))
    return _cycles_per_ms[0]


def kernel_ms(fn, cold: bool = True, calls: int = KERNEL_CALLS,
              warmup: int = 2) -> dict:
    """Device time of one fn() call: each of ``calls`` calls between a pair
    of CUDA events of its own, all of them enqueued behind a device-side
    wait (torch.cuda._sleep) that holds the stream until the host has
    enqueued the last one, so the host's launch rate cannot reach the
    reading.  ``cold``: before each call, outside its events, a read of
    FLUSH_BYTES evicts the L2 (50 MB on an H100), as a caller finds it
    after other work; a read, so that the write-back of dirty lines (the
    last call's output) falls outside the events and none of its own
    falls inside them.  The wait lasts twice the host's own time to enqueue
    the calls, plus 1 ms; where it ends before the last call is enqueued
    (an event after it has completed), the reading is taken again with a
    wait twice as long, and after four tries it raises.  Returns
    {"median", "min", "max"} in ms over the calls."""
    if cold and not _flush:
        _flush.append(torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32,
                                  device="cuda"))
    flush = _flush[0] if cold else None
    events = [tuple(torch.cuda.Event(enable_timing=True) for _ in "se")
              for _ in range(calls)]

    def enqueue():
        for start, end in events:
            if flush is not None:
                flush.sum()
            start.record()
            fn()
            end.record()

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enqueue()
    wait_ms = 2 * (time.perf_counter() - t0) * 1e3 + 1.0
    torch.cuda.synchronize()
    for _ in range(4):
        held = torch.cuda.Event()
        torch.cuda._sleep(int(wait_ms * _sleep_cycles_per_ms()))
        held.record()
        enqueue()
        primed = not held.query()
        torch.cuda.synchronize()
        if primed:
            t = sorted(s.elapsed_time(e) for s, e in events)
            return dict(median=float(np.median(t)), min=t[0], max=t[-1])
        wait_ms *= 2
    raise RuntimeError("kernel_ms: the device-side wait ended before the "
                       "host had enqueued the timed calls, four times")


def kernel_timings(fn, prefix: str = "") -> dict:
    """fn()'s readings under ``prefix``: ``ms`` the cold median of
    kernel_ms with its min and max, ``warm_ms`` the same without the L2
    flush, and ``events10_ms`` cuda_ms's mean of 10 back-to-back calls
    (the kernel rows' earlier method, kept beside them for comparison)."""
    cold, warm = kernel_ms(fn), kernel_ms(fn, cold=False)
    return {f"{prefix}ms": cold["median"], f"{prefix}ms_min": cold["min"],
            f"{prefix}ms_max": cold["max"],
            f"{prefix}warm_ms": warm["median"],
            f"{prefix}warm_ms_min": warm["min"],
            f"{prefix}warm_ms_max": warm["max"],
            f"{prefix}events10_ms": cuda_ms(fn)}


TIMING_KEYS = tuple(p + k for p in ("", "library_") for k in (
    "ms_min", "ms_max", "warm_ms", "warm_ms_min", "warm_ms_max",
    "events10_ms"))


def fmt_times(r: dict, prefix: str = "") -> str:
    """kernel_timings' readings as one phrase of a log line."""
    def g(k):
        return r[prefix + k]
    return (f"cold {g('ms'):.4f} ms ({g('ms_min'):.4f}-{g('ms_max'):.4f} "
            f"over {KERNEL_CALLS}), warm {g('warm_ms'):.4f} ms "
            f"({g('warm_ms_min'):.4f}-{g('warm_ms_max'):.4f}), 10 "
            f"back-to-back {g('events10_ms'):.4f} ms")


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
    busy = busy_us(dev_ev, lo, hi)
    log(f"[profile] {label} under the profiler: wall {wall * 1000:.1f} ms, "
        f"span {(hi - lo) / 1000:.3f} ms, device busy {busy / 1000:.3f} ms, "
        f"idle share {1 - busy / (hi - lo):.4f}")

    # device time by kernel, from the trace's device events alone (the
    # profiler's per-op table would count a kernel under its op as well)
    by_kernel: dict[str, float] = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            k = (kernel_label(e["name"]) if e["cat"] == "kernel"
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


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work, the larger
# of bytes over the memory rate and float32 operations over the peak rate

def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def viterbi_inputs(sigs, dev):
    """The tracker's DP inputs on the card for a list of signals, packed as
    an analysis group packs them: (local, ll_all, valid) of
    tracker._dp_costs after _preprocess, _nccf and _candidates."""
    from magphase_tpu_torch.epochs import tracker
    from magphase_tpu_torch.parallel import analysis_batch as ab
    _, (sig, _, n_frames), _, Tmax, _, _ = ab._host_signal_batch(sigs, FS,
                                                                  4096)
    fs_a = tracker.analysis_rate(FS)[0]
    xa, _ = tracker._preprocess(torch.from_numpy(sig).to(dev), fs=FS)
    nccf, valid = tracker._nccf(xa, torch.from_numpy(n_frames).to(dev),
                                n_frames_max=Tmax, fs_a=fs_a)
    vals, lags = tracker._candidates(nccf)
    return (*tracker._dp_costs(vals, lags, valid, fs_a=fs_a), valid)


def viterbi_tie_inputs(rng, dev, B: int, T: int) -> dict:
    """DP inputs full of ties, from candidates made on the host: every
    candidate a non-peak (-2.0: all voiced states cost 1e6 alike); every
    candidate of a frame alike with one lag an utterance (voiced states tie
    everywhere); values and lags from three each (exact ties in costs and
    jumps) with a tail of invalid frames."""
    from magphase_tpu_torch.epochs import tracker
    K = tracker.N_CAND
    shape = (B, T, K)
    lag_frame = np.broadcast_to(rng.integers(40, 320, (B, T, 1)), shape)
    lag_utt = np.broadcast_to(rng.integers(40, 320, (B, 1, 1)), shape)
    cases = {
        "all -2.0": (np.full(shape, -2.0), lag_frame, np.ones((B, T), bool)),
        "equal costs": (np.broadcast_to(rng.uniform(0.3, 0.99, (B, T, 1)),
                                        shape), lag_utt,
                        np.ones((B, T), bool)),
        "three values, invalid tails": (
            rng.choice([-2.0, 0.5, 0.8], shape),
            rng.choice([50.0, 100.0, 200.0], shape),
            np.arange(T)[None, :] < rng.integers(T // 4, T + 1, B)[:, None]),
    }
    out = {}
    for name, (vals, lags, valid) in cases.items():
        v = torch.from_numpy(np.ascontiguousarray(valid)).to(dev)
        out[name] = (*tracker._dp_costs(
            torch.tensor(vals, dtype=torch.float32, device=dev),
            torch.tensor(lags, dtype=torch.float32, device=dev), v,
            fs_a=tracker.analysis_rate(FS)[0]), v)
    return out


def viterbi_equal(args, what: str) -> int:
    """The kernel's states against the plain version's on the same card
    inputs: raises unless bitwise equal; returns the frames compared."""
    from magphase_tpu_torch.kernels import viterbi as KV
    got, ref = KV.viterbi(*args), KV.viterbi_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"Viterbi kernel: {what}: "
                             f"{int((got != ref).sum())} of {got.numel()} "
                             "states differ from the plain version")
    return got.numel()


def viterbi_work(local, ll_all, valid, states) -> tuple[int, int]:
    """(bytes, float32 operations) of the DP: each input read once and the
    states written once (the back-pointer workspace is the kernel's own);
    per frame after the first and utterance, the 15 x 15 voiced jumps
    (subtract, absolute value, multiply), 256 adds and 256 compares of the
    argmin, and 16 adds, 16 compares and 16 subtracts of the costs."""
    B, T, S = local.shape
    n_ops = B * (T - 1) * (3 * (S - 1) ** 2 + 2 * S * S + 3 * S)
    return nbytes(local, ll_all, valid, states), n_ops


VITERBI_PROBE_STEPS = 12000


def viterbi_chain_ns(dev):
    """(ns, SM cycles) per forward step of the Viterbi kernel's chain alone
    (one half-warp, the exchange through shared memory, no global memory),
    by the probe kernel of csrc/viterbi.cu: what a frame of the kernel
    cannot go below on this card."""
    from magphase_tpu_torch.kernels import viterbi as KV
    ms = cuda_ms(lambda: KV.chain_probe(VITERBI_PROBE_STEPS, dev), reps=5,
                 warmup=1)
    cycles = int(KV.chain_probe(VITERBI_PROBE_STEPS, dev)[1])
    steps = VITERBI_PROBE_STEPS - 1
    return ms * 1e6 / steps, cycles / steps


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


def cuobjdump_sass(library: str, nvcc: str):
    """The SASS listing of a built library by cuobjdump (looked for beside
    ``nvcc``), None where there is no cuobjdump."""
    exe = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc),
                                                    "cuobjdump")
    if not os.path.isfile(exe):
        return None
    return subprocess.run([exe, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def sass_function(sass: str, pattern: str):
    """[(address, instruction)] of the first function whose mangled name
    matches ``pattern``, None if there is none."""
    body = re.search(r"Function : \w*" + pattern + r"\w*\n(.*?)"
                     r"(?=\n\s*Function :|\Z)", sass, re.S)
    if body is None:
        return None
    return [(int(a, 16), op.strip()) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", body.group(1))]


def sass_loops(ins) -> list:
    """Each loop of a function: a backward branch and every instruction
    from its target on."""
    loops = []
    for addr, op in ins:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) <= addr:
            loops.append([(a, o) for a, o in ins
                          if int(m.group(1), 16) <= a <= addr])
    return loops


def probe_sass(library: str, nvcc: str) -> str:
    """The SASS size of the chain probe's step in the built library, by
    cuobjdump: the instructions of the largest loop of
    chain_probe_kernel<true> (a backward branch and everything from its
    target on), the REDUX among them (two a step, so the loop's steps) and
    the instructions per step."""
    sass = cuobjdump_sass(library, nvcc)
    if sass is None:
        return "cuobjdump not found: SASS not counted"
    ins = sass_function(sass, "chain_probe_kernelILb1E")
    if ins is None:
        return "chain_probe_kernel<true> not in cuobjdump's listing"
    loops = [lp for lp in sass_loops(ins)
             if any("REDUX" in o for _, o in lp)]
    if not loops:
        return f"{len(ins)} instructions, no loop with REDUX recognised"
    loop = max(loops, key=len)
    redux = sum("REDUX" in o for _, o in loop)
    return (f"{len(ins)} instructions, the loop {len(loop)} with {redux} "
            f"REDUX: {len(loop) / (redux / 2):.1f} instructions per step")


def ola_sass(library: str, nvcc: str) -> str:
    """SASS instructions per element of the OLA kernels' frame loop, by
    cuobjdump: the smallest loop of ola_kernel<0> (K2) and <1> (K3) that
    holds four or more global loads, its loads (the elements a pass
    handles) and, in K3, its window sites (cosf's range check, one per
    element).  K3's count leaves out its cold paths, which no window value
    takes: cosf's reduction for |x| >= 105615 (the window's argument is
    pi t, t in [0, 1]) and the division's call of its slow path (a branch
    after FCHK and the code up to its target).  The difference of the two
    counts is the window's cost per windowed element."""
    sass = cuobjdump_sass(library, nvcc)
    if sass is None:
        return "cuobjdump not found: SASS not counted"
    per_elem, parts = {}, []
    for kar in (0, 1):
        ins = sass_function(sass, f"ola_kernelILb{kar}E")
        loops = [lp for lp in sass_loops(ins or [])
                 if sum(" LDG" in f" {o}" for _, o in lp) >= 4]
        if not loops:
            return f"ola_kernel<{kar}>: no frame loop recognised"
        loop = min(loops, key=len)
        cold = []
        for i, (addr, op) in enumerate(loop):
            if "105615" in op or op.split()[0] == "FCHK":
                for a2, o2 in loop[i + 1:i + 12]:
                    m = re.match(r"@!P\d BRA 0x([0-9a-f]+)", o2)
                    if m:
                        cold.append((a2, int(m.group(1), 16)))
                        break
        hot = [(a, o) for a, o in loop
               if not any(c0 < a < c1 for c0, c1 in cold)]
        loads = sum(" LDG" in f" {o}" for _, o in hot)
        sites = sum("105615" in o for _, o in loop)
        per_elem[kar] = len(hot) / loads
        parts.append(f"ola_kernel<{kar}> {len(ins)} instructions, frame loop "
                     f"{len(loop)} ({len(loop) - len(hot)} cold) for {loads} "
                     f"elements and {sites} window sites: "
                     f"{per_elem[kar]:.1f} hot per element")
    return "; ".join(parts) + (f"; the window {per_elem[1] - per_elem[0]:.1f}"
                               " per windowed element")


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


def run_analysis_path(dev, a_sigs, a_marks, a_vois, group, Tmax, m_max,
                      S) -> dict:
    """Path 2, wav-in compressed analysis: the tracked lossless witness,
    then the analysis requests with the launch counts from 0 (returned),
    warm timings, the phase split on one group, and the card against the
    CPU on the 8-utterance request."""
    from magphase_tpu_torch.epochs import placement_device as pd
    from magphase_tpu_torch.epochs import tracker
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.kernels import viterbi as KV
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
    KV.reset_launch_counts()
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
    counts = {**K.launch_counts(), **K4.launch_counts(),
              **KV.launch_counts()}
    log(f"[analysis] launches during the analysis path: {counts}; capacity "
        f"fallbacks {ab.capacity_fallbacks - fallbacks}")
    for name in ("frames", "walk", "viterbi"):
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

    # the two phases of one 32-utterance group, and the Viterbi kernel
    # inside phase 1 beside its plain loop, timed by CUDA events on the
    # stream
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
    local, ll_all = tracker._dp_costs(vals, lags, valid, fs_a=fs_a)
    vit = kernel_timings(lambda: KV.viterbi(local, ll_all, valid))
    vit_plain = cuda_ms(lambda: KV.viterbi_plain(local, ll_all, valid),
                        reps=2, warmup=1)
    log(f"[analysis] one group of {len(a_sigs)} utts on the stream: phase 1 "
        f"(track + K4) {p1:.3f} ms, of which the Viterbi kernel "
        f"{fmt_times(vit)} ({vit['ms'] / p1:.4f} of phase 1 cold), its "
        f"plain loop {vit_plain:.3f} ms; phase 2 (K1 + rfft + mel "
        f"compression, F={F}) {p2:.3f} ms")

    # the card against the CPU on the 8-utterance request, float32 output
    req = a_sigs[:8]
    t0 = time.perf_counter()
    cpu = ab.analysis_compressed_batch(req, FS, feat_dtype=np.float32,
                                       device="cpu")
    dt_cpu = time.perf_counter() - t0
    gpu = ab.analysis_compressed_batch(req, FS, feat_dtype=np.float32,
                                       device=dev)
    st, fails = analysis_vs_cpu(gpu, cpu)
    log(f"[analysis] CUDA vs CPU, 8 utts: {st['n_diff']} of {st['n_all']} "
        f"marks differ (by 1 sample; bound {MAX_MARK_DIFF_SHARE} of them); on "
        f"agreeing frames max |diff| {st['s_err']:.3g} on the mel streams "
        f"(bound {TOL_ANALYSIS_STREAMS}), {st['l_err']:.3g} relative on lf0 "
        f"(bound {TOL_ANALYSIS_LF0_REL}); CPU took {dt_cpu * 1000:.1f} ms")
    if fails:
        raise AssertionError("CUDA vs CPU analysis: " + "; ".join(fails))
    return counts


def check_ola(frm, starts, nfrms, O: int, label: str, win=None,
              library=None) -> dict:
    """K2, or K3 with ``win`` = (wl, wr), against its plain version on
    these inputs (K2 bitwise, K3 within TOL_OLA_AR), timed, beside the
    one PyTorch call ``library`` where given.  The bound counts what the
    call needs: the frames f < nfrms[b] read once, the other inputs and the
    (B, O) output once, and per valid frame element one add (K2) or the
    window and the multiply besides (K3: a division, a compare, cos, a
    scale, the multiply and the add, 6).  ``padded_bound_ms`` counts every
    frame of the padded (B, F, N) array, as the rows' earlier bound did."""
    from magphase_tpu_torch.kernels import framing as K
    if win is None:
        def kern():
            return K.ola(frm, starts, nfrms, out_len=O)

        def plain():
            return K.ola_plain(frm, starts, nfrms, out_len=O)
        ops, tol = 1, 0.0
    else:
        def kern():
            return K.ola_anti_ring(frm, starts, nfrms, *win, out_len=O)

        def plain():
            return K.ola_anti_ring_plain(frm, starts, nfrms, *win, out_len=O)
        ops, tol = 6, TOL_OLA_AR
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not (err <= tol and (win is not None or torch.equal(got, ref))):
        raise AssertionError(f"{label}: max |kernel - plain| {err:.3g} > "
                             f"{tol}")
    B, F, N = frm.shape
    n_valid = int(torch.clamp(nfrms, 0, F).sum())
    rest = nbytes(starts, nfrms, got, *(win or ()))
    bnd = bound(n_valid * N * frm.element_size() + rest, ops * n_valid * N)
    r = dict(B=B, F=F, N=N, O=O, max_abs_err=err, **kernel_timings(kern),
             plain_ms=cuda_ms(plain, reps=3), bound_ms=bnd[0],
             bound_by=bnd[1], library_ms=None,
             padded_bound_ms=bound(nbytes(frm) + rest, ops * frm.numel())[0])
    lib = ""
    if library is not None:
        r.update(kernel_timings(library, "library_"))
        lib = f"; scatter_add_ {fmt_times(r, 'library_')}"
    log(f"[kernels] {label} B={B} F={F} N={N} O={O}: max_abs_err {err:.3g} "
        f"kernel {fmt_times(r)}; plain {r['plain_ms']:.4f} ms{lib}; bound "
        f"of the {n_valid} valid frames of {B * F} {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} reached; bound "
        f"of the padded array {r['padded_bound_ms']:.4f} ms, "
        f"{r['padded_bound_ms'] / r['ms']:.1%}")
    return r


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
    copy_ms = kernel_ms(rows_tensor.clone)["median"]
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
    r = dict(max_abs_err=err,
             **kernel_timings(lambda: K5.rfft_fused(x, n)),
             plain_ms=cuda_ms(lambda: K5.rfft_fused_plain(x, n), reps=3),
             bound_ms=bnd[0], bound_by=bnd[1],
             **kernel_timings(lambda: torch.fft.rfft(x), "library_"))
    log(f"[kernels] K5a rfft_fused {what}, rows={rows} n={n}: max_abs_err "
        f"{err:.3g} ({err / peak:.3g} of the peak) kernel {fmt_times(r)}; "
        f"plain {r['plain_ms']:.4f} ms; cuFFT rfft "
        f"{fmt_times(r, 'library_')}; bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); "
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
    r = dict(max_abs_err=err,
             **kernel_timings(lambda: K5.irfft_fused(zr, zi, n)),
             plain_ms=cuda_ms(lambda: K5.irfft_fused_plain(zr, zi, n),
                              reps=3),
             bound_ms=bnd[0], bound_by=bnd[1],
             **kernel_timings(lambda: torch.fft.irfft(z, n=n), "library_"))
    log(f"[kernels] K5b irfft_fused {what}, rows={rows} n={n}: max_abs_err "
        f"{err:.3g} kernel {fmt_times(r)}; plain {r['plain_ms']:.4f} ms; "
        f"cuFFT irfft {fmt_times(r, 'library_')}; bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}); {dft_shares(r, got)}")
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
    """Worst p99 |out - in| away from the edges over a request
    (bench_torch/inputs.py:p99_vs_input); raises on a wrong length, a
    non-finite or silent output or a p99 of one PCM16 step or more."""
    worst, fails = p99_vs_input(outs, req, what)
    if fails:
        raise AssertionError("; ".join(fails))
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
    from magphase_tpu_torch.kernels import viterbi as KV
    from magphase_tpu_torch.kernels import walk as K4
    from magphase_tpu_torch.parallel import analysis_batch as ab
    from magphase_tpu_torch.parallel import copy_synthesis as cs
    from magphase_tpu_torch.utils.padding import bucket_frames
    from magphase_tpu_torch.vocoder import lossless

    K.reset_launch_counts()
    K4.reset_launch_counts()
    KV.reset_launch_counts()
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
              **KV.launch_counts(), **K5.launch_counts()}
    log(f"[copy] launches during the copy-synthesis path: {counts}")
    for name in ("frames", "ola", "walk", "viterbi"):
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


# ---------------------------------------------------------------------------
# the MagPhaseVocoder facade: single-utterance analysis and synthesis from
# wav files, the constant frame rate and the filter-bank mel warp

FACADE_UTTS = 4
FACADE_WARM_RUNS = 5
# batch == single: synthesis_from_compressed_batch(key=k) against the single
# entry given split(k, n)[i], absolute, the JAX package's own bound
# (tests/test_parallel.py); the CPU tests measure 1.2e-7
TOL_BATCH_VS_SINGLE = 2e-4


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(a) for a in x)
    return x


class _Recorder:
    """A stand-in for ``orig`` that records each call as (args, kwargs,
    result), tensors cloned, and passes it on unchanged.  A kernel wrapper
    counts its launches as ``<its own name>.launches += 1``, which lands
    on the stand-in while it is in place: ``launches`` reads and writes
    the wrapper's own count."""

    def __init__(self, orig, calls: list):
        self._orig, self._calls = orig, calls

    def __call__(self, *args, **kw):
        a = _clone(args)
        out = self._orig(*args, **kw)
        self._calls.append((a, kw, _clone(out)))
        return out

    @property
    def launches(self):
        return self._orig.launches

    @launches.setter
    def launches(self, n):
        self._orig.launches = n


@contextlib.contextmanager
def recording(*targets):
    """Record every call of each (module, name) in ``targets`` under
    ``name`` in the dict it yields (_Recorder)."""
    calls = {name: [] for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name, orig in saved:
        setattr(mod, name, _Recorder(orig, calls[name]))
    try:
        yield calls
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def check_path_kernels(calls, what: str) -> dict:
    """K1, K2 and K4 on a path's own calls (recorded by ``recording``): the
    plain version on the inputs each call was given, against the result
    the path got (K1 within TOL_FRAMES, K2 and K4 bitwise).  Returns
    {name: {calls, shapes, max_abs_err}}."""
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.kernels import walk as K4
    out = {}
    for name, plain, tol in (("frames", K.frames_plain, TOL_FRAMES),
                             ("ola", K.ola_plain, 0.0),
                             ("walk", K4.walk_plain, 0.0)):
        err, shapes = 0.0, []
        for i, (args, kw, got) in enumerate(calls[name]):
            got = got if isinstance(got, tuple) else (got,)
            ref = plain(*args, **kw)
            ref = ref if isinstance(ref, tuple) else (ref,)
            e = max(float((g.to(torch.float64) - r.to(torch.float64)).abs()
                          .max()) for g, r in zip(got, ref))
            if not (e <= tol and (tol > 0 or all(
                    torch.equal(g, r) for g, r in zip(got, ref)))):
                raise AssertionError(f"{what} path, {name} call {i} "
                                     f"{tuple(got[0].shape)}: max |kernel - "
                                     f"plain| {e:.3g} > {tol}")
            err = max(err, e)
            shapes.append(tuple(got[0].shape))
        out[name] = dict(calls=len(shapes), shapes=sorted(set(shapes)),
                         max_abs_err=err)
    return out


def _walk_records(calls, name: str) -> list:
    """Per utterance of the recorded walks: (snap signal, f0 track, frame
    step in samples), from the host walk (tracker.place_epochs) or K4."""
    recs = []
    for args, kw, _ in calls[name]:
        if name == "place_epochs":
            _sig, fs, f0, _voi, y_snap, fstep = args
            recs.append((np.asarray(y_snap), np.asarray(f0), fstep * fs))
            continue
        y_snap, f0, _voi, n_sigs, n_frames = (a.cpu().numpy() for a in args)
        recs += [(y_snap[b, :n_sigs[b]], f0[b, :n_frames[b]],
                  kw["frame_step"]) for b in range(len(n_sigs))]
    return recs


def _moved_marks(what, pm_g, pm_c, walk_g, walk_c) -> list:
    """Each mark that the card's walk put elsewhere than the CPU's, with
    the snap signal of both devices at the two places.  A move is bounded
    by one period of the local f0 (the CPU tracker's at the previous mark,
    whose window the walk searched; one sample where that frame is
    unvoiced).  Both walks take the lowest sample of a window, so where
    the two searched the same window each device's gap (y(b) - y(a) on the
    card, y(a) - y(b) on the CPU) is >= 0: the two troughs swap order
    between the devices, and the gaps add up to exactly how far the two
    devices' snap signals differ at a and b.  A negative gap means the
    windows differed (the previous mark or the local f0 did)."""
    (sg, _, _), (sc, f0c, step) = walk_g, walk_c
    rows = []
    for j in np.flatnonzero(pm_g != pm_c):
        a, b = int(pm_g[j]), int(pm_c[j])
        t = pm_c[j - 1] if j > 0 else 0
        f0 = float(f0c[min(len(f0c) - 1, max(0, int(t / step)))])
        period = FS / f0 if f0 > 0 else 1.0
        dev_diff = max(abs(float(sg[a]) - float(sc[a])),
                       abs(float(sg[b]) - float(sc[b])))
        row = dict(what=what, mark=int(j), card=a, cpu=b, move=a - b,
                   period=period, y_card=(float(sg[a]), float(sg[b])),
                   y_cpu=(float(sc[a]), float(sc[b])),
                   gap_card=float(sg[b]) - float(sg[a]),
                   gap_cpu=float(sc[a]) - float(sc[b]), dev_diff=dev_diff,
                   peak=float(np.abs(sc).max()))
        row["tie"] = min(row["gap_card"], row["gap_cpu"]) >= 0.0
        if not abs(a - b) <= period:
            raise AssertionError(f"{what}: mark {j} moved {a - b} samples, "
                                 f"more than one period ({period:.1f}) of "
                                 "the local f0")
        rows.append(row)
    return rows


def _facade_card_vs_cpu(gpu, cpu, what: str, const_rate: bool, walks,
                        f16: bool = False):
    """Compressed features of one utterance, card against CPU.  The marks
    (cumulative shifts): equal in number, at most MAX_MARK_DIFF_SHARE of
    them moved, each by at most one period of the local f0 (_moved_marks;
    ``walks`` are the card's and the CPU's walk records of the
    utterance).  A walk (the single entry's on the host, K4 in
    analyze_batch) snaps each voiced mark to the lowest sample of the
    tracker's snap signal in a window; where two troughs there are equal
    within float32 round-off, the card's and the CPU's tracker outputs may
    pick different ones, so a mark may move by more than one sample (each
    move is logged with the snap values at both places).  The mel streams
    within TOL_ANALYSIS_STREAMS and lf0 within
    TOL_ANALYSIS_LF0_REL relative on the rows whose inputs agree (with
    ``f16``, streams rounded through float16, beyond one float16 step of
    the CPU's value, where round-off may land on the neighbouring step):
    frames
    whose marks agree at f-2 .. f+2, or on the 5 ms grid the rows 0.2 s
    (longer than any unvoiced run of the witnesses, which the voiced-only
    f0 interpolation spans) from every moved mark.  Returns (moved, marks,
    largest move, streams err, lf0 err, rows, moved-mark rows)."""
    pm_g, pm_c = np.cumsum(gpu[4]), np.cumsum(cpu[4])
    if len(pm_g) != len(pm_c):
        raise AssertionError(f"{what}: {len(pm_g)} marks on the card against "
                             f"{len(pm_c)} on the CPU")
    d = np.abs(pm_g - pm_c)
    moved = pm_c[d > 0]
    if len(moved) > MAX_MARK_DIFF_SHARE * len(pm_c):
        raise AssertionError(f"{what}: {len(moved)} of {len(pm_c)} marks "
                             "moved")
    ties = _moved_marks(what, pm_g, pm_c, *walks)
    if gpu[0].shape != cpu[0].shape:
        raise AssertionError(f"{what}: shapes {gpu[0].shape} against "
                             f"{cpu[0].shape}")
    if const_rate:
        t = 240.0 * (np.arange(len(cpu[3])) + 1)
        ok = np.ones(len(t), bool)
        for m in moved:
            ok &= np.abs(t - m) > 0.2 * FS
    else:
        ok = agreeing_frames(pm_g, pm_c)
    def excess(k):
        d = np.abs(gpu[k][ok] - cpu[k][ok])
        if f16:
            d = d - np.spacing(np.abs(cpu[k][ok]).astype(np.float16)
                               ).astype(np.float64)
        return float(d.max(initial=0.0))

    s_err = max(excess(k) for k in range(3))
    v = ok & (cpu[3] > -1e9)
    l_err = float(np.max(np.abs(gpu[3][v] - cpu[3][v]) / np.abs(cpu[3][v]),
                         initial=0.0))
    if not (s_err <= TOL_ANALYSIS_STREAMS and l_err <= TOL_ANALYSIS_LF0_REL
            and np.array_equal(gpu[3] > -1e9, cpu[3] > -1e9)):
        raise AssertionError(f"{what}: card vs CPU streams {s_err:.3g}, lf0 "
                             f"{l_err:.3g} relative, out of bounds")
    return (len(moved), len(pm_c), int(d.max()), s_err, l_err, int(ok.sum()),
            ties)


def _wav_rel(a, b) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"waveform lengths {a.shape} against {b.shape}")
    return float(np.abs(a - b).max() / np.abs(b).max())


def run_facade_path(dev, seed: int) -> dict:
    """Path 5, the README quickstart: MagPhaseVocoder(fs=48000, mag_dim=60,
    phase_dim=45, pf_type="magphase") on FACADE_UTTS witness signals of
    UTT_SECONDS written as PCM16 wavs.  With the launch counts from 0:
    analyze (tracked epochs) -> synthesize on each wav, the same with
    b_const_rate=True, analysis_compressed(b_mag_fbank_mel=True) ->
    synthesis_from_compressed(b_fbank_mel=True), and analyze_batch
    (b_const_rate=True) on the signals; K1, K2 and K4 must have run.  Then
    the card against the CPU (the same calls with device="cpu"), batch ==
    single synthesis, and the cold and warm wall times of analyze and
    synthesize.  K1, K2 and K4 are held to their plain versions on the
    inputs the path gave them (check_path_kernels), and each mark that
    moved between card and CPU is logged with both snap signals there.
    Returns the launch counts and the kernel checks."""
    import tempfile

    from magphase_tpu_torch.epochs import tracker
    from magphase_tpu_torch.io import wav as wav_io
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.kernels import viterbi as KV
    from magphase_tpu_torch.kernels import walk as K4
    from magphase_tpu_torch.models import MagPhaseVocoder
    from magphase_tpu_torch.parallel import batch
    from magphase_tpu_torch.utils.keys import prng_key, split
    from magphase_tpu_torch.vocoder import compressed

    rng = np.random.default_rng(seed + 1000)
    sigs = make_witness_signals(rng, FACADE_UTTS, UTT_SECONDS)[0]
    cfg = dict(fs=FS, mag_dim=MAG_DIM, phase_dim=PHASE_DIM,
               pf_type="magphase")
    key = prng_key(seed)
    fb_kw = dict(mag_dim=MAG_DIM, phase_dim=PHASE_DIM)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_facade_") as tmp:
        wavs = []
        for i, x in enumerate(sigs):
            wavs.append(os.path.join(tmp, f"witness_{i}.wav"))
            wav_io.write_wav(wavs[-1], x, FS)
        signals = [wav_io.read_wav(w)[0] for w in wavs]

        def facade_runs(device, feat_dtype):
            """Every facade call of the path on ``device``: (features and
            waveforms per wav, const-rate features and waveform of wav 0,
            fbank features and waveform of wav 0, analyze_batch output in
            ``feat_dtype``, cold ms of analyze and synthesize)."""
            voc = MagPhaseVocoder(**cfg, device=device)
            voc_c = MagPhaseVocoder(**cfg, b_const_rate=True, device=device)
            sync = (torch.cuda.synchronize if device != "cpu"
                    else (lambda: None))
            sync()
            t0 = time.perf_counter()
            feats = [voc.analyze(wavs[0])]
            sync()
            t1 = time.perf_counter()
            outs = [voc.synthesize(*feats[0], key=key)]
            sync()
            cold = ((t1 - t0) * 1000, (time.perf_counter() - t1) * 1000)
            for w in wavs[1:]:
                feats.append(voc.analyze(w))
                outs.append(voc.synthesize(*feats[-1], key=key))
            f_c = voc_c.analyze(wavs[0])
            w_c = voc_c.synthesize(*f_c, key=key)
            f_fb = compressed.analysis_compressed(
                wavs[0], b_mag_fbank_mel=True, device=device, **fb_kw)
            w_fb = compressed.synthesis_from_compressed(
                *f_fb[:4], FS, b_fbank_mel=True, key=key, device=device)
            batch_c = voc_c.analyze_batch(signals, feat_dtype=feat_dtype)
            return feats, outs, (f_c, w_c), (f_fb, w_fb), batch_c, cold

        K.reset_launch_counts()
        K4.reset_launch_counts()
        KV.reset_launch_counts()
        with recording((K, "frames"), (K, "ola"), (K4, "walk"),
                       (tracker, "place_epochs")) as rec_g:
            feats, outs, (f_c, w_c), (f_fb, w_fb), batch_c, cold = \
                facade_runs(dev, np.float16)
        counts = {**K.launch_counts(), **K4.launch_counts(),
                  **KV.launch_counts()}
        log(f"[facade] launches during the facade path: {counts}")
        for name in ("frames", "ola", "walk", "viterbi"):
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     "facade path")
        kchecks = check_path_kernels(rec_g, "facade")
        log("[facade] kernels against their plain versions on the facade "
            "path's own inputs and results: " + "; ".join(
                f"{n} {r['calls']} calls at {r['shapes']} max |kernel - "
                f"plain| {r['max_abs_err']:.3g}" for n, r in kchecks.items())
            + f" (bounds: frames {TOL_FRAMES}, ola and walk bitwise)")
        for i, (f, w) in enumerate(zip(feats + [f_c, f_fb],
                                       outs + [w_c, w_fb])):
            # at the constant rate the length comes from the backward walk
            # of the 5 ms shift track; else from the features' lf0
            n_want = (expected_out_len(f[3]) if i != FACADE_UTTS
                      else len(sigs[0]))
            if not abs(len(w) - n_want) <= (0 if i != FACADE_UTTS
                                            else 0.05 * n_want):
                raise AssertionError(f"facade run {i}: output length "
                                     f"{len(w)} against {n_want}")
            if not (np.all(np.isfinite(w)) and np.std(w) > 1e-4):
                raise AssertionError(f"facade run {i}: non-finite or silent")
            if not all(np.all(np.isfinite(x)) for x in f[:4]):
                raise AssertionError(f"facade run {i}: non-finite features")
        for i, f in enumerate(batch_c):
            grid = np.arange(240.0, np.cumsum(f[4])[-1], 240.0)
            if f[0].shape != (len(grid), MAG_DIM):
                raise AssertionError(f"analyze_batch(b_const_rate) utt {i}: "
                                     f"{f[0].shape}, {len(grid)} grid rows")

        # the card against the CPU: the same calls, analyze_batch with
        # float32 output (the default float16 rounds card and CPU values
        # that differ by round-off to neighbouring float16 steps)
        t0 = time.perf_counter()
        with recording((tracker, "place_epochs"), (K4, "walk")) as rec_c:
            c_feats, c_outs, (c_f_c, c_w_c), (c_f_fb, c_w_fb), c_batch_c, \
                c_cold = facade_runs("cpu", np.float32)
        dt_cpu = time.perf_counter() - t0
        with recording((K4, "walk")) as rec_b:
            batch_c = MagPhaseVocoder(**cfg, b_const_rate=True,
                                      device=dev).analyze_batch(
                signals, feat_dtype=np.float32)
        # the walks behind each analysis, card and CPU, in call order
        # (one batch walk of a group padded past the 4 utterances)
        if not len(rec_b["walk"]) == len(rec_c["walk"]) == 1:
            raise AssertionError("analyze_batch: one walk expected")
        n = len(signals)
        walks_g = (_walk_records(rec_g, "place_epochs")
                   + _walk_records(rec_b, "walk")[:n])
        walks_c = (_walk_records(rec_c, "place_epochs")
                   + _walk_records(rec_c, "walk")[:n])
        checks = ([(g, c, f"analyze wav {i}", False, True)
                   for i, (g, c) in enumerate(zip(feats, c_feats))]
                  + [(f_c, c_f_c, "analyze b_const_rate", True, True),
                     (f_fb, c_f_fb, "analysis_compressed fbank", False, True)]
                  + [(g, c, f"analyze_batch b_const_rate utt {i}", True, False)
                     for i, (g, c) in enumerate(zip(batch_c, c_batch_c))])
        if not len(walks_g) == len(walks_c) == len(checks):
            raise AssertionError(f"facade path: {len(walks_g)} walks on the "
                                 f"card, {len(walks_c)} on the CPU, "
                                 f"{len(checks)} analyses")
        moved = {True: 0, False: 0}
        marks = {True: 0, False: 0}
        move = {True: 0, False: 0}
        rows = 0
        s_err = l_err = 0.0
        ties = []
        for (g, c, what, const, host), wg, wc in zip(checks, walks_g,
                                                     walks_c):
            mv, mk, mx, se, le, nr, tr = _facade_card_vs_cpu(
                g, c, what, const, (wg, wc))
            moved[host] += mv
            marks[host] += mk
            move[host] = max(move[host], mx)
            rows += nr
            s_err, l_err = max(s_err, se), max(l_err, le)
            ties += tr
        for t in ties:
            log(f"[facade] moved mark {t['mark']} of {t['what']}: card "
                f"{t['card']}, CPU {t['cpu']} ({t['move']:+d} samples; bound "
                f"one period {t['period']:.1f}); snap signal at (card's, "
                f"CPU's) mark: card ({t['y_card'][0]:.9g}, "
                f"{t['y_card'][1]:.9g}) gap {t['gap_card']:.3g}, CPU "
                f"({t['y_cpu'][0]:.9g}, {t['y_cpu'][1]:.9g}) gap "
                f"{t['gap_cpu']:.3g}; card - CPU there up to "
                f"{t['dev_diff']:.3g}, the signal's peak {t['peak']:.4g}; "
                f"the two troughs swap order (a tie within round-off): "
                f"{t['tie']}")
        log(f"[facade] CUDA vs CPU features, {len(checks)} analyses: marks "
            f"moved {moved[True]} of {marks[True]} by the host walk (largest "
            f"move {move[True]} samples), {moved[False]} of {marks[False]} "
            f"by K4 (largest {move[False]}); bound {MAX_MARK_DIFF_SHARE} of "
            f"them in each analysis; on {rows} agreeing rows max "
            f"|diff| {s_err:.3g} on the mel streams (bound "
            f"{TOL_ANALYSIS_STREAMS}), {l_err:.3g} relative on lf0 (bound "
            f"{TOL_ANALYSIS_LF0_REL}); the CPU took {dt_cpu:.1f} s for the "
            "path")

        # the waveform from the same (CPU) features, card against CPU
        voc = MagPhaseVocoder(**cfg, device=dev)
        voc_c = MagPhaseVocoder(**cfg, b_const_rate=True, device=dev)
        rel = max([_wav_rel(voc.synthesize(*f, key=key), w)
                   for f, w in zip(c_feats, c_outs)]
                  + [_wav_rel(voc_c.synthesize(*c_f_c, key=key), c_w_c),
                     _wav_rel(compressed.synthesis_from_compressed(
                         *c_f_fb[:4], FS, b_fbank_mel=True, key=key,
                         device=dev), c_w_fb)])
        if not rel <= TOL_CUDA_VS_CPU:
            raise AssertionError(f"facade synthesis, card vs CPU from the "
                                 f"same features: {rel:.3g} of the peak")
        log(f"[facade] CUDA vs CPU waveforms from the same features, "
            f"{FACADE_UTTS + 2} utts: max|diff|/peak {rel:.3g} (bound "
            f"{TOL_CUDA_VS_CPU})")

        # batch == single on the card, without the output high-pass
        utts = [f[:4] for f in feats]
        by_batch = batch.synthesis_from_compressed_batch(
            utts, FS, key=key, b_out_hpf=False, device=dev)
        keys = split(key, len(utts))
        err = 0.0
        for i, u in enumerate(utts):
            one = compressed.synthesis_from_compressed(
                *u, FS, b_out_hpf=False, key=keys[i], device=dev)
            if one.shape != by_batch[i].shape:
                raise AssertionError(f"batch vs single, utt {i}: lengths")
            err = max(err, float(np.abs(by_batch[i] - one).max()))
        if not err <= TOL_BATCH_VS_SINGLE:
            raise AssertionError(f"batch vs single on the card: {err:.3g}")
        log(f"[facade] batch == single on the card, {len(utts)} utts: max "
            f"|diff| {err:.3g} (bound {TOL_BATCH_VS_SINGLE})")

        # wall times per UTT_SECONDS utterance: the first call of the
        # process (cold) and the median of FACADE_WARM_RUNS warm calls
        walls_a, walls_s = [], []
        for _ in range(FACADE_WARM_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = voc.analyze(wavs[0])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            voc.synthesize(*f, key=key)
            torch.cuda.synchronize()
            walls_a.append((t1 - t0) * 1000)
            walls_s.append((time.perf_counter() - t1) * 1000)
        for name, c, w in (("analyze", cold[0], walls_a),
                           ("synthesize", cold[1], walls_s)):
            log(f"[facade] {name}, one {UTT_SECONDS} s utterance: cold "
                f"{c:.1f} ms, warm median {np.median(w):.1f} ms of "
                f"{FACADE_WARM_RUNS} (min {min(w):.1f}, max {max(w):.1f}); "
                f"the CPU's first call {c_cold[0 if name == 'analyze' else 1]:.1f} ms")
    return counts, kchecks


CLI_UTTS = 64
CLI_SECONDS = (2.5, 2.75, 3.0)       # the corpus's utterance lengths
CLI_CONST_UTTS = 4
CLI_CPU_UTTS = 8
CLI_BAD_AT = 40                      # scp position of the unreadable wav
# int8 against f16 transport: the JAX package's bound on the relative RMS
# (tests/test_transfer_encodings.py:test_int8_transport_synthesis_negligible,
# < 0.02), after the least-squares gain between the two wavs, which are
# peak-normalised each.  Its MSD bound (< 0.5 dB, taken on its demo
# corpus) is not held here: on a witness signal of this corpus the JAX
# package itself measures 0.586 dB, and the port the same within 0.01 dB
# (tests/test_torch_transport.py::test_int8_msd_matches_jax); the card's
# int8 wavs are held to the CPU's instead.
TOL_INT8_REL = 0.02


def _wav_tree(d, toks) -> dict:
    """{token: the wav's bytes} of a generated corpus."""
    return {t: open(os.path.join(d, t + ".wav"), "rb").read() for t in toks}


def _pcm(path) -> np.ndarray:
    from magphase_tpu_torch.io import read_wav
    sig, fs = read_wav(path)
    if fs != FS:
        raise AssertionError(f"{path}: {fs} Hz")
    return np.rint(sig * 32768.0).astype(np.int64)


def _same_wavs(a: dict, b: dict, what: str) -> None:
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: other tokens")
    diff = [t for t in a if a[t] != b[t]]
    if diff:
        raise AssertionError(f"{what}: {len(diff)} of {len(a)} wavs differ "
                             f"in their bytes, first {diff[0]}")


def run_cli_path(dev, seed: int) -> tuple:
    """Path 6, the corpus CLI (python -m magphase_tpu_torch.cli) at full
    width: CLI_UTTS witness signals of 2.5-3 s at 48 kHz written as PCM16
    wavs with an scp (one unreadable wav among them), fft_len 4096, 60/45
    dims, pf_type magphase.  With the launch counts from 0, in-process
    through cli.main: extract --batch-size 32 (K4, K1; the bad wav on the
    crash list, rc 1, its chunk-mates done), generate --batch-size 16
    (pipelined, pcm16; K2), the same at --batch-size 5, through the
    fallback runner, and with --transport int8, extract --const-rate and
    generate --const-rate on CLI_CONST_UTTS utterances, convert-labels on
    synthetic labels, eval of the round trip; then a `serve` daemon as a
    subprocess with two generate --server requests.  Checks: K1, K2 and K4
    held to their plain versions on every call of a second, recorded run
    of the extract, the batch-16 generate and the const-rate generate
    (each byte-identical to its first run); byte-identical wavs
    (pipelined, fallback, batch 16 and 5, both serve requests); no token
    through the fallback runner or a retry in the other runs; the native
    reader in use; card against CPU (generate, f16 and int8, and extract
    of CLI_CPU_UTTS utterances with --device cpu); int8 against f16.
    Returns the launch counts (the timed runs') and the kernel checks."""
    import io
    import select
    import tempfile

    from magphase_tpu_torch import cli
    from magphase_tpu_torch.io import native, read_binfile, read_wav
    from magphase_tpu_torch.io import wav as wav_io
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.kernels import viterbi as KV
    from magphase_tpu_torch.kernels import walk as K4
    from magphase_tpu_torch.parallel import analysis_batch as ab
    from magphase_tpu_torch.parallel import batch
    from magphase_tpu_torch.utils import corpus
    from magphase_tpu_torch.utils.eval import mel_spectral_distortion

    if not (native.build() and native.available()):
        raise AssertionError("the native corpus-IO library did not build "
                             "or load: extract would read with the Python "
                             "codec")
    rng = np.random.default_rng(seed + 2000)
    sigs = make_witness_signals(rng, CLI_UTTS, max(CLI_SECONDS))[0]
    sigs = [x[:int(CLI_SECONDS[i % len(CLI_SECONDS)] * FS)]
            for i, x in enumerate(sigs)]
    toks = [f"w{i:03d}" for i in range(CLI_UTTS)]
    audio_s = sum(len(x) for x in sigs) / FS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        def d(name):
            return os.path.join(tmp, name)

        os.makedirs(d("wavs"))
        for t, x in zip(toks, sigs):
            wav_io.write_wav(d(f"wavs/{t}.wav"), x, FS)
        with open(d("wavs/broken.wav"), "wb") as f:
            f.write(b"RIFFgarbage")

        def scp(name, tokens):
            with open(d(name), "w") as f:
                f.write("\n".join(tokens) + "\n")
            return d(name)

        scp_ex = scp("extract.scp", toks[:CLI_BAD_AT] + ["broken"]
                     + toks[CLI_BAD_AT:])
        scp_all = scp("all.scp", toks)
        scp_cpu = scp("cpu.scp", toks[:CLI_CPU_UTTS])
        scp_const = scp("const.scp", toks[:CLI_CONST_UTTS])

        def run(argv, what, rc_want=0, audio=audio_s):
            """One in-process CLI call: rc checked; wall seconds,
            audio-s/s and peak device memory logged."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if rc != rc_want:
                raise AssertionError(f"cli {what}: rc {rc}, expected "
                                     f"{rc_want}")
            log(f"[cli] {what}: {dt:.3f} s wall, {audio / dt:.1f} audio-s/s "
                f"({audio:.1f} audio-s), peak device memory "
                f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.3f}"
                f" GiB above the {base / 2 ** 30:.3f} GiB held before it")
            return dt

        def gen(out, *extra, what, scp_path=scp_all, feats="feats",
                audio=audio_s):
            """generate, with the calls of the pipelined entry and of the
            fallback runner counted: one pipelined call and no fallback."""
            with recording((batch, "synthesis_batches_pipelined"),
                           (corpus, "run_corpus_batched")) as rec:
                run(["generate", "--scp", scp_path, "--feats-dir", d(feats),
                     "--out-dir", d(out), "--batch-size", "16",
                     "--pf-type", "magphase", *extra], what, audio=audio)
            n_pipe = len(rec["synthesis_batches_pipelined"])
            n_fall = len(rec["run_corpus_batched"])
            if (n_pipe, n_fall) != (1, 0):
                raise AssertionError(f"cli {what}: {n_pipe} pipelined runs "
                                     f"(a retry beyond 1) and {n_fall} "
                                     "fallback runs: a hidden fallback")

        const_s = sum(len(x) for x in sigs[:CLI_CONST_UTTS]) / FS

        def extract(out, what):
            run(["extract", "--scp", scp_ex, "--wav-dir", d("wavs"),
                 "--out-dir", d(out), "--batch-size", "32",
                 "--crash-list", d(f"crash_{out}.scp")], what, rc_want=1)

        def gen_const(out, what):
            run(["generate", "--scp", scp_const, "--feats-dir", d("feats_c"),
                 "--out-dir", d(out), "--const-rate", "--pf-type",
                 "magphase"], what, audio=const_s)

        K.reset_launch_counts()
        K4.reset_launch_counts()
        KV.reset_launch_counts()
        fallbacks0 = ab.capacity_fallbacks
        extract("feats", "extract --batch-size 32 (one unreadable wav)")
        with open(d("crash_feats.scp")) as f:
            crashed = f.read().split()
        if crashed != ["broken"]:
            raise AssertionError(f"extract crash list {crashed}")
        missing = [t for t in toks for ext in (".mag", ".real", ".imag",
                                               ".lf0", ".shift")
                   if not os.path.exists(d(f"feats/{t}{ext}"))]
        if missing:
            raise AssertionError(f"extract: {len(missing)} feature files "
                                 f"missing, first {missing[0]}")
        if ab.capacity_fallbacks != fallbacks0:
            raise AssertionError("extract: a walk hit its capacity")

        gen("wav16", what="generate --batch-size 16")
        wav16 = _wav_tree(d("wav16"), toks)
        for t in toks:
            x = _pcm(d(f"wav16/{t}.wav"))
            if not (len(x) > 2 * FS and np.abs(x).max() > 16000):
                raise AssertionError(f"generate {t}: {len(x)} samples, peak "
                                     f"{np.abs(x).max()}")

        gen("wav5", "--batch-size", "5", what="generate --batch-size 5")
        _same_wavs(wav16, _wav_tree(d("wav5"), toks),
                   "generate --batch-size 5 against 16")
        gen("wav8", "--transport", "int8", what="generate --transport int8")
        rel, msd = 0.0, []
        for t in toks:
            a = _pcm(d(f"wav8/{t}.wav")).astype(np.float64)
            b = _pcm(d(f"wav16/{t}.wav")).astype(np.float64)
            if a.shape != b.shape:
                raise AssertionError(f"int8 {t}: {a.shape} vs {b.shape}")
            g = float(a @ b) / float(a @ a)
            rel = max(rel, float(np.sqrt(np.mean((g * a - b) ** 2))
                                 / np.sqrt(np.mean(b ** 2))))
            msd.append(mel_spectral_distortion(a / 32768.0, b / 32768.0,
                                               FS))
        log(f"[cli] int8 against f16 transport, {CLI_UTTS} wavs: relative "
            f"RMS after the gain at most {rel:.4g} (bound {TOL_INT8_REL}); "
            f"MSD mean {np.mean(msd):.4f} dB, max {max(msd):.4f} dB")
        if not 0.0 < rel < TOL_INT8_REL:
            raise AssertionError("int8 transport out of the JAX package's "
                                 "bound")

        # extract --const-rate -> generate --const-rate (single synthesis)
        run(["extract", "--scp", scp_const, "--wav-dir", d("wavs"),
             "--out-dir", d("feats_c"), "--batch-size", "32",
             "--const-rate"], "extract --const-rate", audio=const_s)
        gen_const("wav_c", "generate --const-rate")
        for t, x in zip(toks, sigs[:CLI_CONST_UTTS]):
            n = len(read_binfile(d(f"feats_c/{t}.lf0"), 1))
            if os.path.exists(d(f"feats_c/{t}.shift")) or \
                    not abs(n - len(x) / 240.0) <= 2:
                raise AssertionError(f"const-rate features of {t}: {n} "
                                     "frames")
            y, _ = read_wav(d(f"wav_c/{t}.wav"))
            if not (abs(len(y) - len(x)) < 0.05 * FS and np.all(
                    np.isfinite(y)) and np.std(y) > 1e-4):
                raise AssertionError(f"const-rate wav of {t}: {len(y)} "
                                     f"samples for {len(x)}")
        # the fallback runner renders the pipelined path's bytes
        def boom(*a, **kw):
            raise RuntimeError("forced: exercise the fallback runner")

        orig = batch.synthesis_batches_pipelined
        batch.synthesis_batches_pipelined = boom
        try:
            run(["generate", "--scp", scp_all, "--feats-dir", d("feats"),
                 "--out-dir", d("wav_fb"), "--batch-size", "16",
                 "--pf-type", "magphase"], "generate, fallback runner")
        finally:
            batch.synthesis_batches_pipelined = orig
        _same_wavs(wav16, _wav_tree(d("wav_fb"), toks),
                   "generate through the fallback runner")

        counts = {**K.launch_counts(), **K4.launch_counts(),
                  **KV.launch_counts()}
        log(f"[cli] launches during the CLI path: {counts}")
        for name in ("frames", "ola", "walk", "viterbi"):
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     "CLI path")

        # the kernels on the CLI's own inputs: extract, generate and the
        # const-rate generate again, every K1, K2 and K4 call recorded
        # (the timed runs above are not, so their peak memory holds no
        # recorded copies), each output byte-identical to its first run
        with recording((K, "frames"), (K, "ola"), (K4, "walk")) as rec:
            extract("feats_rec", "extract again, recorded")
            gen("wav_rec", what="generate --batch-size 16 again, recorded")
            gen_const("wav_c_rec", "generate --const-rate again, recorded")
        for t in toks:
            for ext in (".mag", ".real", ".imag", ".lf0", ".shift"):
                with open(d(f"feats/{t}{ext}"), "rb") as f1, \
                        open(d(f"feats_rec/{t}{ext}"), "rb") as f2:
                    if f1.read() != f2.read():
                        raise AssertionError(f"extract {t}{ext}: a second "
                                             "run wrote other bytes")
        _same_wavs(wav16, _wav_tree(d("wav_rec"), toks),
                   "generate, second run")
        _same_wavs(_wav_tree(d("wav_c"), toks[:CLI_CONST_UTTS]),
                   _wav_tree(d("wav_c_rec"), toks[:CLI_CONST_UTTS]),
                   "generate --const-rate, second run")
        kchecks = check_path_kernels(rec, "cli")
        # the walks of the first chunk (scp order: the unreadable wav
        # stops the length sort) cover the card-vs-CPU utterances
        walks_g = _walk_records(rec, "walk")[:CLI_CPU_UTTS]
        del rec
        torch.cuda.empty_cache()
        log("[cli] kernels against their plain versions on the CLI's own "
            "inputs and results: " + "; ".join(
                f"{n} {r['calls']} calls at {r['shapes']} max |kernel - "
                f"plain| {r['max_abs_err']:.3g}" for n, r in kchecks.items()))

        # convert-labels on synthetic HTS labels over each .shift track
        os.makedirs(d("labs"))
        for t in toks[:CLI_CONST_UTTS]:
            ep_ms = np.cumsum(read_binfile(d(f"feats/{t}.shift"), 1)) \
                * 1000.0 / FS
            cuts = np.linspace(0, int(np.ceil((ep_ms[-1] + 1.0) * 1e4)),
                               31).astype(np.int64)
            with open(d(f"labs/{t}.lab"), "w") as f:
                for i in range(30):
                    f.write(f"{cuts[i]} {cuts[i + 1]} ph{i // 5}[{i % 5}]\n")
        run(["convert-labels", "--scp", scp_const, "--shift-dir",
             d("feats"), "--lab-dir", d("labs"), "--out-dir",
             d("labs_var")], "convert-labels", audio=const_s)
        for t in toks[:CLI_CONST_UTTS]:
            rows = [ln.split() for ln in open(d(f"labs_var/{t}.lab"))]
            st = np.asarray([int(r[0]) for r in rows])
            en = np.asarray([int(r[1]) for r in rows])
            n = len(read_binfile(d(f"feats/{t}.shift"), 1))
            if not (len(rows) == 30 and st[0] == 0
                    and np.array_equal(st[1:], en[:-1])
                    and en[-1] == n * 50000):
                raise AssertionError(f"convert-labels {t}: not {n} frames "
                                     "of 5 ms in 30 contiguous states")

        # eval: the round trip, and a corpus against itself
        for ref, cand, what in (("wavs", "wav16", "round trip"),
                                ("wav16", "wav16", "identity")):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                run(["eval", "--scp", scp_all, "--ref-dir", d(ref),
                     "--cand-dir", d(cand)], f"eval {what}")
            out = buf.getvalue().splitlines()
            print("\n".join(ln for ln in out if ln.startswith("[cli]")),
                  flush=True)
            res = json.loads([ln for ln in out if ln.startswith("{")][-1])
            if what == "identity":
                if res["mean_db"] != 0.0:
                    raise AssertionError(f"eval identity {res['mean_db']}")
                continue
            per = np.asarray(list(res["per_utt"].values()))
            if not (len(per) == CLI_UTTS and np.all(np.isfinite(per))
                    and np.all(per > 0)):
                raise AssertionError(f"eval round trip: {res}")
            log(f"[cli] eval, input wavs against the round trip: MSD mean "
                f"{res['mean_db']} dB, per utterance {per.min():.3f}-"
                f"{per.max():.3f} dB")

        # the card against the CPU
        walk_c = {}
        with recording((K4, "walk")) as rec_c:
            cpu_s = sum(len(x) for x in sigs[:CLI_CPU_UTTS]) / FS
            run(["extract", "--scp", scp_cpu, "--wav-dir", d("wavs"),
                 "--out-dir", d("feats_cpu"), "--batch-size", "32",
                 "--device", "cpu"], "extract --device cpu", audio=cpu_s)
        gen("wav_cpu", "--device", "cpu", what="generate --device cpu",
            scp_path=scp_cpu, audio=cpu_s)
        gen("wav8_cpu", "--device", "cpu", "--transport", "int8",
            what="generate --device cpu --transport int8", scp_path=scp_cpu,
            audio=cpu_s)
        for card, host in (("wav16", "wav_cpu"), ("wav8", "wav8_cpu")):
            steps = 0
            for t in toks[:CLI_CPU_UTTS]:
                x = _pcm(d(f"{host}/{t}.wav"))
                y = _pcm(d(f"{card}/{t}.wav"))
                if x.shape != y.shape or np.abs(x - y).max() > 1:
                    raise AssertionError(f"generate {t} ({card}), card vs "
                                         "CPU: more than one PCM16 step")
                steps += int(np.sum(x != y))
            log(f"[cli] generate ({card}), card vs CPU, {CLI_CPU_UTTS} wavs: "
                f"PCM16 samples within one step (bound 1), {steps} samples "
                "one step apart")
        walks_c = _walk_records(rec_c, "walk")[:CLI_CPU_UTTS]
        moved = marks = move = rows = 0
        s_err = l_err = 0.0
        for i, t in enumerate(toks[:CLI_CPU_UTTS]):
            g, c = ([read_binfile(d(f"{k}/{t}{ext}"), dim) for ext, dim in
                     ((".mag", MAG_DIM), (".real", PHASE_DIM),
                      (".imag", PHASE_DIM), (".lf0", 1), (".shift", 1))]
                    for k in ("feats", "feats_cpu"))
            mv, mk, mx, se, le, nr, ties = _facade_card_vs_cpu(
                g, c, f"extract {t}", False, (walks_g[i], walks_c[i]),
                f16=True)
            moved, marks, move, rows = (moved + mv, marks + mk,
                                        max(move, mx), rows + nr)
            s_err, l_err = max(s_err, se), max(l_err, le)
            for r in ties:
                log(f"[cli] extract {t}, card vs CPU: mark {r['mark']} moved "
                    f"{r['move']:+d} samples (one period {r['period']:.1f});"
                    f" troughs swap order: {r['tie']}")
        log(f"[cli] extract, card vs CPU, {CLI_CPU_UTTS} utts: {moved} of "
            f"{marks} marks moved (largest {move} samples; bound "
            f"{MAX_MARK_DIFF_SHARE} of them, each within one period); on "
            f"{rows} agreeing rows the float16 mel streams differ by at most "
            f"{s_err:.3g} beyond one float16 step (bound "
            f"{TOL_ANALYSIS_STREAMS}), lf0 {l_err:.3g} relative (bound "
            f"{TOL_ANALYSIS_LF0_REL})")

        # the serve daemon: two generate --server requests, each the
        # in-process batch-16 run's bytes
        sock = d("mp.sock")
        srv = subprocess.Popen(
            [sys.executable, "-m", "magphase_tpu_torch.cli", "serve",
             "--socket", sock], cwd=os.path.dirname(os.path.abspath(
                 __file__)), stdout=subprocess.PIPE, text=True)
        try:
            t0 = time.perf_counter()
            ready, _, _ = select.select([srv.stdout], [], [], 300.0)
            line = srv.stdout.readline() if ready else ""
            if "serving on" not in line:
                raise AssertionError(f"serve did not start: {line!r}")
            log(f"[cli] serve: ready in {time.perf_counter() - t0:.3f} s")
            walls = []
            for k in (1, 2):
                t0 = time.perf_counter()
                rc = cli.main(["generate", "--scp", scp_all, "--feats-dir",
                               d("feats"), "--out-dir", d(f"wav_srv{k}"),
                               "--batch-size", "16", "--pf-type", "magphase",
                               "--server", sock])
                walls.append(time.perf_counter() - t0)
                if rc != 0:
                    raise AssertionError(f"serve request {k}: rc {rc}")
                _same_wavs(wav16, _wav_tree(d(f"wav_srv{k}"), toks),
                           f"serve request {k}")
            log(f"[cli] serve, two generate --server requests of {CLI_UTTS} "
                f"utts: {walls[0]:.3f} s and {walls[1]:.3f} s wall "
                f"({audio_s / walls[0]:.1f} and {audio_s / walls[1]:.1f} "
                "audio-s/s), both byte-identical to the in-process run")
            if cli.main(["serve", "--socket", sock, "--shutdown"]) != 0:
                raise AssertionError("serve --shutdown failed")
            srv.wait(timeout=60)
        finally:
            if srv.poll() is None:
                srv.kill()
                srv.wait(timeout=60)
            srv.stdout.close()
        if srv.returncode != 0:
            raise AssertionError(f"serve exited with {srv.returncode}")
        log(f"[cli] byte-identical wavs: pipelined = fallback runner = batch "
            f"16 = batch 5 = serve request 1 = serve request 2, {CLI_UTTS} "
            "wavs each; no token through the fallback runner or a retry "
            f"outside the forced run; native reader in use: "
            f"{native.available()}")
    return counts, kchecks


VARIANT_UTTS = 4
VARIANT_WARM_RUNS = 3
# card against CPU on one shorter witness, without the repeats of the
# b_norm_mag streams and two of the four Griffin-Lim inits
VARIANT_CMP_SECONDS = 1.0
VARIANT_CMP_SKIP = ("type2 analysis b_norm_mag", "type2 synthesis b_norm_mag",
                    "griffin_lim linear", "griffin_lim array")
# variants, card against CPU from the same inputs.  Syntheses: the CPU
# tests hold the port against the JAX package at up to 1e-6 of the peak
# (tests/test_torch_variants.py, float32 FFT round-off of two FFT
# libraries), the card's cuFFT being a third: TOL_CUDA_VS_CPU, as the
# serving request.  Griffin-Lim runs of 10-50 iterations: the phase of
# near-zero bins diverges between FFT libraries, so they are held by their
# magnitude (the 512-point STFT of the output, relative in the Frobenius
# norm, or the spectral convergence against the target magnitude), and
# how far apart two runs land depends on the input: the card may differ
# from the CPU by at most GL_SPREAD_FACTOR times the most that GL_SPREAD_RUNS
# CPU runs from inputs perturbed by one float32 ulp differ from the CPU's
# own run, and never by more than TOL_GL_REL need (the CPU tests' bound
# against JAX, measured 3.9e-4 there for 50 iterations).
TOL_GL_REL = 1e-3
GL_SPREAD_RUNS = 3
GL_SPREAD_FACTOR = 2.0
# type-2 analysis, card against CPU: its magnitude is the true envelope
# of the lossless magnitudes, which lifts each frame's valleys over 6-32
# iterations, and the weak bins' FFT round-off (relative to the frame's
# peak) moves the lift: on the CPU the port and the JAX package differ by
# up to 0.0057 on the log-mel magnitude (0.11 dB on the envelope) for a
# 1 s witness of this script; the bound is ten times that.  Its phase
# streams are held to TOL_ANALYSIS_STREAMS.
TOL_TYPE2_MAG = 0.057
# the true envelope alone from the same input (ncoeffs 600, as the type-2
# analysis), card against CPU: a frame freezes once its mean |spectrum -
# smoothed| drops below 0.1 dB, a threshold round-off may cross an
# iteration apart on the two devices.  Such frames are counted; the rest
# agree within ten times the CPU's port-vs-JAX difference on one input
# (6.1e-5 dB measured on that witness; tests/test_torch_spectral.py holds
# the freeze iterations equal on 60 frames).
TOL_ENVELOPE_DB = 6.1e-4
# whitened tracking, card against CPU: a clipped or cubed segment across a
# voicing boundary is nearly all zeros, its NCCF normalisation sits at its
# 1e-12 floor and magnifies round-off (tests/test_torch_tracker.py::
# test_whitened_nccf_matches_jax), so marks there may move: at least this
# share of the CPU's marks must have a card mark within one sample
MIN_WHITEN_MARK_MATCH = 0.9


def _stft_rel(a, b) -> float:
    """||STFT-mag(a) - STFT-mag(b)|| / ||STFT-mag(b)||, 512 points."""
    from scipy import signal as sp_signal
    sa = np.abs(sp_signal.stft(a, FS, nperseg=512)[2])
    sb = np.abs(sp_signal.stft(b, FS, nperseg=512)[2])
    return float(np.linalg.norm(sa - sb) / np.linalg.norm(sb))


def _spectral_convergence(mag, shifts, sig, device) -> float:
    """||mag(sig) - target|| / ||target|| of a Griffin-Lim output, its
    magnitude re-analysed at the target's marks."""
    from magphase_tpu_torch.vocoder import lossless
    pm = np.cumsum(shifts)
    got = lossless.analysis_with_del_comp_from_pm(
        sig, FS, pm, np.ones(len(pm)), fft_len=4096, device=device)[0]
    n = min(len(got), len(mag))
    return float(np.linalg.norm(got[:n] - mag[:n]) / np.linalg.norm(mag[:n]))


def _perturbed(results: dict, seed: int) -> dict:
    """``results`` with the float streams that the syntheses and
    Griffin-Lim read (the type-1 features and the lossless magnitude)
    each multiplied by 1 + u * 2^-23, u uniform in [-1, 1): a
    perturbation of one float32 ulp."""
    rng = np.random.default_rng(seed)
    out = dict(results)
    for name in ("type1 analysis", "lossless analysis"):
        first = np.asarray(results[name][0])
        out[name] = (first * (1.0 + rng.uniform(-1.0, 1.0, first.shape)
                              * 2.0 ** -23),) + tuple(results[name][1:])
    return out


def _gl_measure(cpu: dict):
    """measure(name, a, b): the relative difference of two Griffin-Lim
    outputs of entry ``name``: of their spectral convergence against the
    target magnitude for griffin_lim, of their STFT magnitudes for the
    type1-old syntheses."""
    def measure(name, a, b):
        if not name.startswith("griffin_lim"):
            return _stft_rel(a, b)
        mag, shifts = cpu["lossless analysis"][0], cpu["lossless analysis"][4]
        sa = _spectral_convergence(mag, shifts, a[0], "cpu")
        sb = _spectral_convergence(mag, shifts, b[0], "cpu")
        return abs(sa - sb) / sb
    return measure


def _variant_entries(wav, pm_sec, voi, key, device, first: bool):
    """The variants path on one wav as (name, call) pairs, in order: each
    call takes the results so far (a dict) and returns its own.  ``first``
    adds the type1-old Griffin-Lim syntheses and the Griffin-Lim runs."""
    import magphase_tpu_torch.vocoder as V
    from magphase_tpu_torch.io import wav as wav_io
    from magphase_tpu_torch.utils.keys import split
    ep = dict(pm_sec=pm_sec, voi=voi, device=device)
    dims = dict(mag_dim=MAG_DIM, phase_dim=PHASE_DIM)
    syn = dict(key=key, device=device)
    e = [("type1 analysis", lambda r: V.analysis_compressed_type1(
            wav, **dims, **ep)),
         ("type1 analysis const-rate", lambda r: V.analysis_compressed_type1(
             wav, const_rate_ms=5.0, **dims, **ep)),
         ("type1 synthesis", lambda r: V.synthesis_from_compressed_type1(
             *r["type1 analysis"][:4], FS, **syn)),
         ("type1 synthesis min_phase",
          lambda r: V.synthesis_from_compressed_type1(
              *r["type1 analysis"][:4], FS, per_phase_type="min_phase",
              **syn)),
         ("type1 synthesis const-rate",
          lambda r: V.synthesis_from_compressed_type1(
              *r["type1 analysis const-rate"][:4], FS, b_const_rate=True,
              **syn)),
         ("type2 analysis", lambda r: V.analysis_compressed_type2(
             wav, **dims, **ep)),
         ("type2 analysis b_norm_mag", lambda r: V.analysis_compressed_type2(
             wav, b_norm_mag=True, **dims, **ep)),
         ("type2 synthesis", lambda r: V.synthesis_from_compressed_type2(
             *r["type2 analysis"][:4], FS, **syn)),
         ("type2 synthesis b_norm_mag",
          lambda r: V.synthesis_from_compressed_type2(
              *r["type2 analysis b_norm_mag"][:4], FS, **syn)),
         ("phase-comp analysis",
          lambda r: V.analysis_compressed_type1_with_phase_comp(
              wav, **dims, **ep)),
         ("phase-comp synthesis",
          lambda r: V.synthesis_from_compressed_type1_with_phase_comp(
              *r["phase-comp analysis"][:4], FS, **syn)),
         ("type1-old synthesis",
          lambda r: V.synthesis_from_compressed_type1_old_with_griffin_lim(
              *r["type1 analysis"][:4], FS, **syn))]
    if not first:
        return e
    for gl in ("det", "whole"):
        e.append((f"type1-old synthesis gl={gl}", lambda r, gl=gl:
                  V.synthesis_from_compressed_type1_old_with_griffin_lim(
                      *r["type1 analysis"][:4], FS, griff_lim_type=gl,
                      **syn)))
    e.append(("lossless analysis", lambda r: V.analysis_with_del_comp_from_pm(
        wav_io.read_wav(wav)[0], FS, pm_sec * FS, voi, fft_len=4096,
        device=device)))
    for init in ("random", "linear", "min_phase", "array"):
        e.append((f"griffin_lim {init}", lambda r, init=init: V.griffin_lim(
            r["lossless analysis"][0], r["lossless analysis"][4],
            phase_init=(init if init != "array" else np.random.default_rng(
                0).uniform(-np.pi, np.pi, r["lossless analysis"][0].shape)),
            key=split(key, 2)[1], device=device)))
    return e


def _check_variant_outputs(name, out, sig_len: int) -> None:
    """Every waveform finite, not silent and of the length its features
    give (2 pm[-1] - pm[-2] + 1; within 5% of the signal's at the
    constant rate, whose marks come from the backward shift walk); every
    analysis stream finite."""
    if "analysis" in name:
        if not all(np.all(np.isfinite(np.asarray(x, np.float64)))
                   for x in out[:4]):
            raise AssertionError(f"variants: {name}: non-finite streams")
        return
    w = out[0] if name.startswith("griffin_lim") else out
    if not (np.all(np.isfinite(w)) and np.std(w) > 1e-4):
        raise AssertionError(f"variants: {name}: non-finite or silent")
    if not abs(len(w) - sig_len) <= 0.05 * sig_len:
        raise AssertionError(f"variants: {name}: {len(w)} samples for a "
                             f"{sig_len}-sample signal")


def run_variants_path(dev, seed: int, feats, keys_all) -> tuple:
    """Path 7, the variant vocoders on VARIANT_UTTS witness wavs of
    UTT_SECONDS (48 kHz, fft_len 4096, 60/45 dims), with the launch counts
    from 0: type1 analysis (variable and 5 ms rate) into type1 synthesis
    ('magphase', 'min_phase', constant rate), type2 analysis (with and
    without b_norm_mag) into type2 synthesis, phase-comp analysis into
    phase-comp synthesis, the type1-old synthesis (and on the first wav
    its 'det' and 'whole' Griffin-Lim forms), and griffin_lim on the first
    wav's lossless magnitudes for each phase_init; then one 128-utterance
    serving request under MAGPHASE_HPF_MODE=blocked in two batch
    compositions, and extract_epochs under MAGPHASE_TRACKER_WHITEN=clip30
    and cube.  K1 and K2 must launch; every call of them on the variants
    entries is held to its plain version.  The entries run on the CPU too,
    on a shorter witness wav, card against CPU.  Logs cold and warm wall
    ms and peak memory per entry.  Returns (launch counts, kernel
    checks)."""
    import tempfile

    from magphase_tpu_torch.core.spectral import true_envelope_freeze
    from magphase_tpu_torch.epochs import extract_epochs
    from magphase_tpu_torch.io import wav as wav_io
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.kernels import viterbi as KV
    from magphase_tpu_torch.kernels import walk as K4
    from magphase_tpu_torch.parallel import batch
    from magphase_tpu_torch.utils.keys import prng_key, split

    rng = np.random.default_rng(seed + 2000)
    sigs, marks, vois = make_witness_signals(rng, VARIANT_UTTS, UTT_SECONDS)
    keys = split(prng_key(seed + 7), VARIANT_UTTS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_") as tmp:
        wavs = []
        for i, x in enumerate(sigs):
            wavs.append(os.path.join(tmp, f"variant_{i}.wav"))
            wav_io.write_wav(wavs[-1], x, FS)
        paths = [_variant_entries(w, m / FS, v, k, dev, i == 0)
                 for i, (w, m, v, k) in enumerate(zip(wavs, marks, vois,
                                                      keys))]

        K.reset_launch_counts()
        K4.reset_launch_counts()
        KV.reset_launch_counts()
        cold, results = {}, []
        with recording((K, "frames"), (K, "ola"), (K4, "walk")) as rec:
            for i, entries in enumerate(paths):
                r = {}
                for name, fn in entries:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r[name] = fn(r)
                    torch.cuda.synchronize()
                    if i == 0:
                        cold[name] = (time.perf_counter() - t0) * 1000
                    _check_variant_outputs(name, r[name], len(sigs[i]))
                results.append(r)
        counts_entries = {**K.launch_counts(), **K4.launch_counts(),
                          **KV.launch_counts()}
        log(f"[variants] launches on the variants entries of {VARIANT_UTTS} "
            f"wavs: {counts_entries}")
        for name in ("frames", "ola"):
            if counts_entries[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     "variants path")
        kchecks = check_path_kernels(rec, "variants")
        del rec
        log("[variants] kernels against their plain versions on the variants "
            "entries' own inputs and results: " + "; ".join(
                f"{n} {c['calls']} calls at {c['shapes'][:4]}"
                f"{' ...' if len(c['shapes']) > 4 else ''} max |kernel - "
                f"plain| {c['max_abs_err']:.3g}" for n, c in kchecks.items())
            + f" (bounds: frames {TOL_FRAMES}, ola bitwise)")

        # warm wall times and peak memory per entry, on the first wav
        r = {}
        for name, fn in paths[0]:
            walls = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(VARIANT_WARM_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r[name] = fn(r)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1000)
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            log(f"[variants] {name}, one {UTT_SECONDS} s wav: cold "
                f"{cold[name]:.1f} ms, warm median {np.median(walls):.1f} ms "
                f"of {VARIANT_WARM_RUNS} (min {min(walls):.1f}, max "
                f"{max(walls):.1f}), peak {peak:.1f} MiB")

        # card against CPU on a shorter witness wav (the CPU's Griffin-Lim
        # and true envelope take minutes at 3 s): each analysis on both
        # devices, each synthesis on both from the CPU's features
        x, m, v = (a[0] for a in make_witness_signals(
            rng, 1, VARIANT_CMP_SECONDS))
        cmp_wav = os.path.join(tmp, "variant_cmp.wav")
        wav_io.write_wav(cmp_wav, x, FS)

        def cmp_entries(device):
            return [(n, f) for n, f in _variant_entries(
                cmp_wav, m / FS, v, keys[0], device, True)
                if n not in VARIANT_CMP_SKIP]

        t0 = time.perf_counter()
        cpu = {}
        for name, fn in cmp_entries("cpu"):
            cpu[name] = fn(cpu)
        dt_cpu = time.perf_counter() - t0
        cpu_fns = dict(cmp_entries("cpu"))
        gl_measure = _gl_measure(cpu)
        errs, syn_err, gl_err = {}, {}, {}
        for name, fn in cmp_entries(dev):
            c = cpu[name]
            if name == "lossless analysis":
                continue    # held card against CPU on the copy-synthesis path
            if "analysis" in name:
                g = fn({})
                errs[name] = ([float(np.max(np.abs(np.asarray(
                    a, np.float64) - np.asarray(b, np.float64))))
                    for a, b in zip(g[:3], c[:3])],
                    bool(np.array_equal(g[3], c[3])))
                continue
            g = fn(cpu)     # the card's synthesis from the CPU's features
            if name.startswith("griffin_lim") or "gl=" in name:
                spread = max(gl_measure(name, cpu_fns[name](_perturbed(
                    cpu, seed)), c) for seed in range(GL_SPREAD_RUNS))
                gl_err[name] = (gl_measure(name, g, c), spread)
            else:
                if g.shape != c.shape:
                    raise AssertionError(f"variants: {name}: {g.shape} on "
                                         f"the card, {c.shape} on the CPU")
                syn_err[name] = float(np.abs(g - c).max() / np.abs(c).max())
        log(f"[variants] CUDA vs CPU on a {VARIANT_CMP_SECONDS} s witness "
            "wav, mel streams (max |diff| of mag, real, imag; lf0 equal): "
            + ", ".join(f"{n} {e[0][0]:.3g} {e[0][1]:.3g} {e[0][2]:.3g} "
                        f"{e[1]}" for n, e in errs.items())
            + f"; bounds {TOL_ANALYSIS_STREAMS}, the type2 magnitude "
            f"{TOL_TYPE2_MAG}; the CPU took {dt_cpu:.1f} s for the wav's "
            "entries")
        # the true envelope from the same magnitudes on both devices
        mag = torch.from_numpy(cpu["lossless analysis"][0].astype(
            np.float32))
        env_c, at_c = true_envelope_freeze(mag, ncoeffs=600)
        env_g, at_g = true_envelope_freeze(mag.to(dev), ncoeffs=600)
        same = (at_g.cpu() == at_c).numpy()
        env_db = np.abs(20 * np.log10(env_g.cpu().numpy())
                        - 20 * np.log10(env_c.numpy())).max(axis=1)
        env_err = float(np.nanmax(env_db[same], initial=0.0))
        log(f"[variants] true envelope (ncoeffs 600) of the witness's "
            f"{len(same)} lossless frames, card against CPU: "
            f"{int((~same).sum())} frames froze at another iteration; the "
            f"others within {env_err:.3g} dB (bound {TOL_ENVELOPE_DB}); "
            f"frames freeze at iterations {int(at_c.min())}-"
            f"{int(at_c.max())}")
        log("[variants] CUDA vs CPU syntheses from the same features "
            "(max|diff|/peak): " + ", ".join(
                f"{n} {e:.3g}" for n, e in syn_err.items())
            + f"; bound {TOL_CUDA_VS_CPU}")
        log("[variants] CUDA vs CPU Griffin-Lim (relative difference of the "
            "STFT magnitude, or of the spectral convergence), beside the "
            f"most that {GL_SPREAD_RUNS} CPU runs from one-ulp perturbed "
            "inputs differ from the CPU's: " + ", ".join(
                f"{n} {e[0]:.3g} (spread {e[1]:.3g})"
                for n, e in gl_err.items())
            + f"; bound max({GL_SPREAD_FACTOR} x spread, {TOL_GL_REL})")
        bad = ([n for n, e in errs.items() if not e[1] or max(e[0][1:]) >
                TOL_ANALYSIS_STREAMS or e[0][0] > (
                    TOL_TYPE2_MAG if "type2" in n else TOL_ANALYSIS_STREAMS)]
               + (["true envelope"] if env_err > TOL_ENVELOPE_DB else [])
               + [n for n, e in syn_err.items() if e > TOL_CUDA_VS_CPU]
               + [n for n, e in gl_err.items()
                  if e[0] > max(GL_SPREAD_FACTOR * e[1], TOL_GL_REL)])
        if bad:
            raise AssertionError(f"variants, card vs CPU out of bounds: {bad}")

    # one serving request under MAGPHASE_HPF_MODE=blocked, in two batch
    # compositions of the same utterances: byte-identical audio
    n = len(feats)
    order = np.random.default_rng(seed + 3).permutation(n)
    old = os.environ.get("MAGPHASE_HPF_MODE")
    os.environ["MAGPHASE_HPF_MODE"] = "blocked"
    try:
        walls = []
        outs = []
        for idx in (np.arange(n), order, np.arange(n)):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = batch.synthesis_from_compressed_batch(
                [feats[i] for i in idx], FS, pf_type="magphase",
                keys=keys_all[idx], det_fft_syn=True, device=dev)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1000)
            outs.append(dict(zip(idx.tolist(), w)))
        peak = torch.cuda.max_memory_allocated()
    finally:
        if old is None:
            del os.environ["MAGPHASE_HPF_MODE"]
        else:
            os.environ["MAGPHASE_HPF_MODE"] = old
    same = sum(np.array_equal(outs[0][i], outs[1][i]) for i in range(n))
    for i in range(n):
        w = outs[0][i]
        if not (len(w) == expected_out_len(feats[i][3])
                and np.all(np.isfinite(w)) and np.std(w) > 1e-4):
            raise AssertionError(f"blocked request, utt {i}: bad output")
    spectral = batch.synthesis_from_compressed_batch(
        feats, FS, pf_type="magphase", keys=keys_all, det_fft_syn=True,
        device=dev)
    d_mode = max(float(np.abs(a - outs[0][i]).max()) for i, a in
                 enumerate(spectral))
    audio_s = sum(len(w) for w in outs[0].values()) / FS
    log(f"[variants] MAGPHASE_HPF_MODE=blocked, {n} utts ({audio_s:.1f} "
        f"audio-s), det_fft_syn: {same} of {n} utterances byte-identical "
        f"across two batch compositions (in order, and permuted); wall "
        f"{walls[0]:.1f} ms cold, {walls[2]:.1f} ms warm "
        f"({audio_s / walls[2] * 1000:.1f} audio-s/s), peak "
        f"{peak / 2 ** 30:.3f} GiB; max |blocked - spectral| "
        f"{d_mode:.3g} (the two forms of the high-pass)")
    if same != n:
        raise AssertionError(f"blocked high-pass: {n - same} utterances "
                             "depend on the batch composition")

    # the tracker's whitening modes, card against CPU
    for mode in ("clip30", "cube"):
        os.environ["MAGPHASE_TRACKER_WHITEN"] = mode
        try:
            match, total, n_g = 0, 0, 0
            for x in sigs:
                pm_g, _ = extract_epochs(x, FS, device=dev)
                pm_c, _ = extract_epochs(x, FS, device="cpu")
                a, b = np.round(pm_g * FS), np.round(pm_c * FS)
                if not (len(a) > 50 and np.all(np.diff(a) > 0)):
                    raise AssertionError(f"whiten={mode}: bad marks")
                j = np.clip(np.searchsorted(a, b), 1, len(a) - 1)
                near = np.minimum(np.abs(a[j] - b), np.abs(a[j - 1] - b))
                match += int(np.sum(near <= 1))
                total += len(b)
                n_g += len(a)
        finally:
            del os.environ["MAGPHASE_TRACKER_WHITEN"]
        log(f"[variants] MAGPHASE_TRACKER_WHITEN={mode}, {len(sigs)} "
            f"witness signals: {n_g} marks on the card, {total} on the CPU, "
            f"{match / total:.4f} of the CPU's within one sample of a card "
            f"mark (bound {MIN_WHITEN_MARK_MATCH})")
        if match < MIN_WHITEN_MARK_MATCH * total:
            raise AssertionError(f"whiten={mode}: card and CPU marks differ")

    counts = {**K.launch_counts(), **K4.launch_counts(),
              **KV.launch_counts()}
    log(f"[variants] launches during the variants path: {counts}")
    if counts["viterbi"] <= 0:
        raise AssertionError("kernel viterbi was not launched by "
                             "extract_epochs on the variants path")
    return counts, kchecks


# ---------------------------------------------------------------------------
# data parallelism, multi-process corpus runs and the serving example

MESH_REQUEST = 128          # serving utterances through each mesh
MESH_ANALYSIS = 96          # analysis and copy-synthesis utterances
MESH_LOSSLESS = 32          # analysis_lossless_batch from given epochs
MESH_TIMING_RUNS = 3
# peak memory of the 2-logical-shard analysis and copy-synthesis requests
# against mesh=None: the budget is per card, so the split holds the same
# group at once
MESH_PEAK_TOL = 0.10
MP_UTTS = 16
MP_SECONDS = 2.0
# the serving example's PCM16 on the card against the CPU: the float32
# waveforms agree within TOL_CUDA_VS_CPU of the peak (0.64 codes after the
# 0.98 peak normalisation), so rounding moves a sample by one code at most
TOL_EXAMPLE_CODES = 1


def _timed(fn, mesh):
    """(result, wall ms, peak device memory in GiB summed over the mesh's
    cards) of one request, every card of the mesh synced."""
    from magphase_tpu_torch.parallel.mesh import DataMesh, synchronize
    mesh = mesh or DataMesh(["cuda"])
    cards = set(mesh.devices)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    synchronize(mesh)
    t0 = time.perf_counter()
    out = fn()
    synchronize(mesh)
    return out, (time.perf_counter() - t0) * 1e3, sum(
        torch.cuda.max_memory_allocated(d) for d in cards) / 2 ** 30


def _max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(a, b))


def run_mesh_path(dev, seed: int, feats, keys_all, a_sigs, a_marks,
                  a_vois) -> tuple:
    """Path 8, data parallelism (parallel/mesh.py): data_mesh() over the
    visible cards, a logical mesh of 2 shards on one card, and one of 3
    shards with 2 utterances (the mesh size does not divide the bucket of
    8).  Each against the same call with mesh=None, bitwise: the
    128-utterance serving request and synthesis_batches_pipelined (PCM16),
    a 96-utterance analysis request (marks and streams; 3 budget groups),
    a 96-utterance copy-synthesis (each output also p99 < 2^-15 of its
    input) and analysis_lossless_batch from given epochs.  K1, K2 and K4
    held to their plain versions on every recorded call of the split runs;
    then wall ms and peak memory per request, unrecorded, none and 2
    shards in turns, the 2-shard analysis and copy-synthesis peaks within
    MESH_PEAK_TOL of none's.  Returns the launch counts (the checked mesh
    runs') and the kernel checks."""
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.kernels import viterbi as KV
    from magphase_tpu_torch.kernels import walk as K4
    from magphase_tpu_torch.parallel import analysis_batch as ab
    from magphase_tpu_torch.parallel import batch
    from magphase_tpu_torch.parallel import copy_synthesis as cs
    from magphase_tpu_torch.parallel.mesh import DataMesh, data_mesh

    req = [a_sigs[i % len(a_sigs)] for i in range(MESH_ANALYSIS)]
    eps = [(np.asarray(m) / FS, v) for m, v in zip(a_marks, a_vois)]
    half = MESH_REQUEST // 2
    batches = [(feats[:half], keys_all[:half]),
               (feats[half:MESH_REQUEST], keys_all[half:MESH_REQUEST])]

    def requests(mesh, n_serve=MESH_REQUEST, n_req=MESH_ANALYSIS):
        kw = dict(mesh=mesh) if mesh is not None else dict(device=dev)
        return {
            "serve": lambda: batch.synthesis_from_compressed_batch(
                feats[:n_serve], FS, pf_type="magphase",
                keys=keys_all[:n_serve], **kw),
            "pipelined": lambda: [r for g in batch.synthesis_batches_pipelined(
                batches, FS, pf_type="magphase", pcm16=True,
                consume=lambda rows, host: [x.copy() for x in rows], **kw)
                for r in g],
            "analysis": lambda: ab.analysis_compressed_batch(
                req[:n_req], FS, **kw),
            "copy": lambda: cs.copy_synthesis_batch(req[:n_req], FS, **kw),
            "lossless": lambda: ab.analysis_lossless_batch(
                a_sigs[:MESH_LOSSLESS], FS, epochs=eps[:MESH_LOSSLESS],
                **kw),
        }

    def compare(name, got, ref, what):
        if name in ("serve", "pipelined"):
            diff = [i for i, (a, b) in enumerate(zip(got, ref))
                    if not np.array_equal(a, b)]
            if diff or len(got) != len(ref):
                raise AssertionError(f"{what} {name}: {len(diff)} of "
                                     f"{len(ref)} outputs differ from "
                                     "mesh=None")
            return "byte-identical"
        if name == "copy":
            _p99_vs_input(got, req[:len(got)], f"{what} copy-synthesis")
            if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"{what} copy-synthesis: max |mesh - "
                                     f"none| {_max_diff(got, ref):.3g}, not "
                                     "bitwise")
            return "bitwise, each output p99 < 2^-15 of its input"
        if name == "analysis":
            for i, (g, r) in enumerate(zip(got, ref)):
                if not np.array_equal(g[4], r[4]):
                    raise AssertionError(f"{what} analysis utt {i}: marks "
                                         "differ from mesh=None")
            if not all(np.array_equal(g[k], r[k]) for g, r in
                       zip(got, ref) for k in range(4)):
                errs = [_max_diff([g[k] for g in got], [r[k] for r in ref])
                        for k in range(4)]
                raise AssertionError(f"{what} analysis streams: max |diff| "
                                     f"{errs}, not bitwise")
            return "marks equal, streams bitwise"
        errs = [_max_diff([g[k] for g in got], [r[k] for r in ref])
                for k in range(5)]
        if errs[3] != 0 or errs[4] != 0:
            raise AssertionError(f"{what} lossless: f0/shift differ")
        peak = max(float(np.abs(r[0]).max()) for r in ref)
        if not errs[0] <= TOL_LOSSLESS_MAG_REL * peak:
            raise AssertionError(f"{what} lossless magnitudes {errs[0]:.3g}")
        if not all(np.array_equal(g[k], r[k]) for g, r in
                   zip(got, ref) for k in range(3)):
            raise AssertionError(f"{what} lossless: max |diff| {errs[:3]}, "
                                 "not bitwise")
        return "bitwise"

    visible = data_mesh()
    logical2 = DataMesh([dev, dev])
    logical3 = DataMesh([dev] * 3)
    none = {name: fn() for name, fn in requests(None).items()}
    none3 = {n: f() for n, f in requests(None, 2, 2).items()
             if n in ("serve", "analysis", "copy")}

    K.reset_launch_counts()
    K4.reset_launch_counts()
    KV.reset_launch_counts()
    checks = {}
    for mesh, label, rec_it in ((visible, f"data_mesh() x{visible.size}",
                                 False),
                                (logical2, "2 logical shards", True)):
        for name, fn in requests(mesh).items():
            if rec_it:
                with recording((K, "frames"), (K, "ola"), (K4, "walk")) as rc:
                    got = fn()
                for k, r in check_path_kernels(rc, f"mesh {name}").items():
                    c = checks.setdefault(k, dict(calls=0, max_abs_err=0.0))
                    c["calls"] += r["calls"]
                    c["max_abs_err"] = max(c["max_abs_err"],
                                           r["max_abs_err"])
                del rc
            else:
                got = fn()
            log(f"[mesh] {label} {name}: "
                f"{compare(name, got, none[name], label)}")
    for name, fn in requests(logical3, 2, 2).items():
        if name in none3:
            log(f"[mesh] 3 shards, 2 utts {name}: "
                f"{compare(name, fn(), none3[name], '3 shards, 2 utts')}")
    counts_mesh = {**K.launch_counts(), **K4.launch_counts(),
                   **KV.launch_counts()}

    # wall and peak memory of each request, unrecorded, in turns; the peaks
    # of the highest run of each side
    for name in requests(None):
        walls = {"none": [], "2 shards": []}
        peaks = {"none": [], "2 shards": []}
        for _ in range(MESH_TIMING_RUNS):
            for key, mesh in (("none", None), ("2 shards", logical2)):
                _, ms, gib = _timed(requests(mesh)[name], mesh)
                walls[key].append(ms)
                peaks[key].append(gib)
        mem = {k: max(v) for k, v in peaks.items()}
        med = {k: float(np.median(v)) for k, v in walls.items()}
        log(f"[mesh] {name}, {MESH_TIMING_RUNS} runs each in turns: median "
            f"wall none {med['none']:.1f} ms (min {min(walls['none']):.1f}, "
            f"max {max(walls['none']):.1f}), 2 logical shards "
            f"{med['2 shards']:.1f} ms (min {min(walls['2 shards']):.1f}, max "
            f"{max(walls['2 shards']):.1f}), {med['2 shards'] / med['none']:.3f}"
            f"x; peak none {mem['none']:.3f} GiB, 2 shards "
            f"{mem['2 shards']:.3f} GiB "
            f"({mem['2 shards'] / mem['none']:.3f}x)")
        # two logical shards of one card share its one budget: a group
        # holds what the unsplit call's group holds
        if name in ("analysis", "copy") and not \
                abs(mem["2 shards"] / mem["none"] - 1.0) <= MESH_PEAK_TOL:
            raise AssertionError(
                f"mesh {name}: peak with 2 logical shards "
                f"{mem['2 shards']:.3f} GiB is not within "
                f"{MESH_PEAK_TOL:.0%} of mesh=None's {mem['none']:.3f} GiB")

    counts = counts_mesh
    log(f"[mesh] launches during the mesh runs: {counts}; kernels held to "
        f"plain on the split runs' calls: {checks}")
    for name in ("frames", "ola", "walk"):
        if counts[name] <= 0 or checks.get(name, {}).get("calls", 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "mesh path")
    if counts["viterbi"] <= 0:
        raise AssertionError("kernel viterbi was not launched on the mesh "
                             "path")
    return counts, checks


_MP_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from magphase_tpu_torch import cli
from magphase_tpu_torch.kernels import framing as K
from magphase_tpu_torch.kernels import viterbi as KV
from magphase_tpu_torch.kernels import walk as K4
from magphase_tpu_torch.parallel import mesh
rcs = [cli.main(json.loads(a)) for a in sys.argv[3:]]
json.dump(dict(rcs=rcs, rank=mesh.rank(), size=mesh.world_size(),
               counts={**K.launch_counts(), **K4.launch_counts(),
                       **KV.launch_counts()}),
          open(sys.argv[2], "w"))
"""


def run_multiproc_path(dev, seed: int) -> dict:
    """Path 9, a multi-process corpus run: MP_UTTS witness wavs of
    MP_SECONDS s; `cli extract` then `cli generate` in this process, then
    in two worker processes that meet in a gloo group (the JAX CLI's
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) and both
    run on this card.  Their per-process manifests must be a disjoint cover
    and the merged feature and wav trees byte-identical to the one
    process's.  Returns the workers' launch counts."""
    import socket
    import tempfile

    from magphase_tpu_torch import cli
    from magphase_tpu_torch.io import wav as wav_io

    rng = np.random.default_rng(seed + 3000)
    sigs = make_witness_signals(rng, MP_UTTS, MP_SECONDS)[0]
    toks = [f"m{i:02d}" for i in range(MP_UTTS)]
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as tmp:
        def d(*p):
            return os.path.join(tmp, *p)

        os.makedirs(d("wavs"))
        for t, x in zip(toks, sigs):
            wav_io.write_wav(d("wavs", t + ".wav"), x, FS)
        with open(d("ids.scp"), "w") as f:
            f.write("\n".join(toks) + "\n")

        def argv(out):
            return (["extract", "--scp", d("ids.scp"), "--wav-dir",
                     d("wavs"), "--out-dir", d(out, "feats"),
                     "--batch-size", "4"],
                    ["generate", "--scp", d("ids.scp"), "--feats-dir",
                     d(out, "feats"), "--out-dir", d(out, "wavs"),
                     "--batch-size", "4"])

        t0 = time.perf_counter()
        for a in argv("one"):
            if cli.main(a) != 0:
                raise AssertionError(f"cli {a[0]} in one process failed")
        t_one = time.perf_counter() - t0

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                            "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                            "MASTER_PORT")}
        procs = []
        t0 = time.perf_counter()
        try:
            for r in range(2):
                e = dict(env, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                         JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r))
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _MP_WORKER, root,
                     d(f"worker{r}.json"),
                     *(json.dumps(a) for a in argv("two"))],
                    env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            for r, p in enumerate(procs):
                _, err = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise AssertionError(f"multiproc worker {r}: rc "
                                         f"{p.returncode}\n{err[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        t_two = time.perf_counter() - t0
        res = [json.load(open(d(f"worker{r}.json"))) for r in range(2)]
        if [(x["rank"], x["size"], x["rcs"]) for x in res] != [
                (0, 2, [0, 0]), (1, 2, [0, 0])]:
            raise AssertionError(f"multiproc workers: {res}")
        for sub in ("feats", "wavs"):
            shards = [set(json.load(open(d("two", sub,
                                           f".magphase_manifest.p{r}.json")))
                          ["done"]) for r in range(2)]
            if shards[0] & shards[1] or shards[0] | shards[1] != set(toks):
                raise AssertionError(f"multiproc {sub}: the manifests are "
                                     "no disjoint cover")
            one = {f: open(d("one", sub, f), "rb").read()
                   for f in os.listdir(d("one", sub))
                   if not f.startswith(".")}
            two = {f: open(d("two", sub, f), "rb").read()
                   for f in os.listdir(d("two", sub))
                   if not f.startswith(".")}
            if one.keys() != two.keys() or any(one[f] != two[f]
                                               for f in one):
                raise AssertionError(f"multiproc {sub}: the merged tree "
                                     "differs from one process's")
        counts = {k: sum(x["counts"][k] for x in res)
                  for k in res[0]["counts"]}
        log(f"[multiproc] {MP_UTTS} wavs of {MP_SECONDS} s, extract + "
            f"generate: one process {t_one:.2f} s (in this process, kernels "
            f"built), two processes {t_two:.2f} s (each from its start); "
            f"manifests {[len(s) for s in shards]} a disjoint cover, merged "
            f"feature and wav trees byte-identical; worker launches {counts}")
        for name in ("frames", "ola", "walk", "viterbi"):
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by the "
                                     "multi-process workers")
    return counts


def run_example_path(dev, seed: int) -> tuple:
    """Path 10, the serving example
    (magphase_tpu_torch/examples/serving_on_device.py): tts_step at B=8,
    F=256 on the card (acoustic MLP -> unwarp -> synthesis (K2) -> device
    PCM16), K2 held to its plain version on its own calls, the PCM16
    against the CPU's within TOL_EXAMPLE_CODES; then the port's tracker
    (extract_epochs) on utils/tracker_eval.make_stimulus at the clean
    thresholds of tests/test_tracker_groundtruth.py.  Returns the launch
    counts and the K2 check."""
    from magphase_tpu_torch.epochs import extract_epochs
    from magphase_tpu_torch.examples import serving_on_device as ex
    from magphase_tpu_torch.kernels import framing as K
    from magphase_tpu_torch.utils.keys import prng_key, split
    from magphase_tpu_torch.utils.tracker_eval import (make_stimulus,
                                                       tracker_metrics)

    model = ex.init_acoustic_model(seed)
    ling = torch.randn(ex.B, ex.F, ex.LING_DIM,
                       generator=torch.Generator().manual_seed(seed + 1))
    keys = torch.from_numpy(split(prng_key(seed + 2), ex.B).astype(np.int64))
    K.reset_launch_counts()
    tab = ex.synthesis_tables(dev)
    model_d = model.to(dev)
    with recording((K, "ola")) as rc:
        (pcm, lens), ms, mem = _timed(lambda: ex.tts_step(
            model_d, ling.to(dev), keys.to(dev), tab), None)
    counts = K.launch_counts()
    check = check_path_kernels(dict(rc, frames=[], walk=[]),
                               "serving example")["ola"]
    (_, _), warm, _ = _timed(lambda: ex.tts_step(
        model_d, ling.to(dev), keys.to(dev), tab), None)
    pcm, lens = pcm.cpu().numpy(), lens.cpu().numpy()
    cpu, lens_c = (x.numpy() for x in ex.tts_step(
        model.cpu(), ling, keys, ex.synthesis_tables("cpu")))
    codes = int(np.abs(pcm.astype(np.int32) - cpu).max())
    audio_s = float(lens.sum()) / ex.FS
    if not (np.array_equal(lens, lens_c) and codes <= TOL_EXAMPLE_CODES):
        raise AssertionError(f"serving example: card vs CPU {codes} codes, "
                             f"lengths {lens} vs {lens_c}")
    if counts["ola"] <= 0 or check["calls"] <= 0:
        raise AssertionError("serving example: K2 was not launched")
    log(f"[example] serving_on_device tts_step B={ex.B} F={ex.F} "
        f"({audio_s:.1f} audio-s): {ms:.1f} ms first call, {warm:.1f} ms "
        f"warm ({audio_s / warm * 1e3:.1f} audio-s/s), peak {mem:.3f} GiB; "
        f"card vs CPU PCM16 within {codes} codes; K2 {check}; launches "
        f"{counts}")

    # the tracker's clean ground-truth gates (tests/test_tracker_
    # groundtruth.py: SYNTH_CASES, seed 1)
    cases = {"steady120": [(0.3, 120, 120)], "rise90_180": [(0.4, 90, 180)],
             "fall300_150": [(0.4, 300, 150)], "high350": [(0.3, 350, 350)],
             "low60": [(0.4, 60, 60)], "low_male_55_85": [(0.5, 55, 85)],
             "mixed": [(0.2, None, None), (0.3, 140, 200),
                       (0.15, None, None), (0.3, 220, 110),
                       (0.1, None, None)]}
    worst = dict(gpe=0.0, voi_miss=0.0, voi_fa=0.0, gci_hit=1.0,
                 gci_jitter=0.0)
    for name, segs in cases.items():
        sig, gci, ivals, f0_at = make_stimulus(FS, segs, seed=1)
        pm, voi = extract_epochs(sig, FS, device=dev)
        m = tracker_metrics(pm, voi, gci, ivals, f0_at, len(sig) / FS)
        if not (m["gpe"] < 0.01 and m["voi_miss"] < 0.02
                and m["voi_fa"] < 0.03 and m["gci_hit"] > 0.93
                and m["gci_jitter"] < 1.0e-3):
            raise AssertionError(f"tracker ground truth {name}: {m}")
        for k in worst:
            worst[k] = (min if k == "gci_hit" else max)(worst[k], m[k])
    log(f"[example] tracker on {len(cases)} make_stimulus cases on the "
        f"card: worst {worst} (gates gpe < 0.01, voi_miss < 0.02, voi_fa < "
        "0.03, gci_hit > 0.93, jitter < 1 ms)")
    return counts, check


def run_bench_phase(seed: int) -> None:
    """The benchmark, bench_torch/run.py, once at the least depth in a
    process of its own: both cells at one timed request (after its warm
    pass), with every check and control of a full run.  Fails unless it
    exits 0 and each cell's line parses with correct: true."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.join(root, "bench_torch", "run.py"),
           "--seed", str(seed), "--timed", "1"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=900)
    wall = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    cells = {ln["cell"]: ln for ln in lines if "metrics" in ln}
    for name, ln in cells.items():
        m = ln["metrics"]
        layers_ms = {k.split(".", 1)[1]: round(v, 3) for k, v in m.items()
                     if k.startswith("device_ms.")}
        log(f"[bench] {name}: correct {ln['correct']}, "
            f"{m['throughput_audio_s_per_s']:.1f} audio-s/s, p50 "
            f"{m['latency_ms_p50']:.1f} ms over {m['latency_samples']} "
            f"timed requests, peak {m['peak_mem_gib']:.3f} GiB, idle share "
            f"{m['device_idle_share']:.4f}, device ms per request by layer "
            f"{layers_ms}, kernel launches per request "
            f"{m['launches_per_request.kernels']}, tracing overhead "
            f"{m['tracing_overhead']:.3f}; checks {ln['checks']}; failures "
            f"{ln['failures']}")
    log(f"[bench] bench_torch/run.py --timed 1: exit "
        f"{res.returncode} in {wall:.1f} s")
    if (res.returncode != 0 or sorted(cells) != sorted(BENCH_CELLS)
            or not all(ln["correct"] for ln in cells.values())):
        raise AssertionError(f"the benchmark failed (exit {res.returncode},"
                             f" cells {sorted(cells)}): "
                             f"{res.stderr[-3000:]}")


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
    from magphase_tpu_torch.kernels import viterbi as KV
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
    infos = _build.build(K.SOURCE, K4.SOURCE, K5.SOURCE, KV.SOURCE)
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
    from magphase_tpu_torch.utils.keys import prng_key, split
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
        max_abs_err=err,
        **kernel_timings(lambda: K.frames(*k1_args, **k1_kw)),
        plain_ms=cuda_ms(lambda: K.frames_plain(*k1_args, **k1_kw), reps=3),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
    # the card's practical rate for the same stores: a fill of the output
    shape = tuple(got.shape)
    del got, ref
    fill_ms = kernel_ms(lambda: torch.zeros(shape, device=dev))["median"]
    r = results["frames"]
    log(f"[kernels] K1 frames B={B} F={F} N=4096 S={S}: max_abs_err {err:.3g} "
        f"kernel {fmt_times(r)}; plain {r['plain_ms']:.4f} ms bound "
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

    results["ola"] = check_ola(frm, starts, s_nfrms, O, "ola",
                               library=ola_library)
    del flat, frm_flat
    results["ola_anti_ring"] = check_ola(frm, starts, s_nfrms, O,
                                         "ola_anti_ring", win=(wl, wr))
    # what bounds K3: the same call with every window one sample wide (its
    # division and cosf run on one element per frame), beside K2
    k3_ms = results["ola_anti_ring"]["ms"]
    one = torch.zeros_like(wl)
    k3_one_ms = kernel_ms(lambda: K.ola_anti_ring(
        frm, starts, s_nfrms, one, one, out_len=O))["median"]
    support = float(((wl + wr + 1).clamp(max=fft_syn) * (
        torch.arange(Fs_, device=dev)[None, :] < s_nfrms[:, None])).sum())
    log(f"[kernels] K3 window cost: K3 {k3_ms:.4f} ms, K3 with every window "
        f"one sample wide {k3_one_ms:.4f} ms, K2 {results['ola']['ms']:.4f} "
        f"ms; the windows cover {support / (int(s_nfrms.sum()) * fft_syn):.1%}"
        f" of the valid frames' elements; K3 SASS: "
        f"{ola_sass(infos['framing']['path'], _build.find_nvcc())}")
    del one

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
        max_abs_err=k4_err,
        **kernel_timings(lambda: K4.walk(*k4_args, **k4_kw)),
        plain_ms=cuda_ms(lambda: K4.walk_plain(*k4_args, **k4_kw), reps=2,
                         warmup=1),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
        bytes_bound_ms=bytes_bnd[0], chain_ns_per_step=chain_ns)
    r = results["walk"]
    log(f"[kernels] K4 walk B={len(a_sigs)} S={S_a} T={Tmax_a} "
        f"m_max={m_max_a} snap_w={pd._snap_win(FS)}: bitwise equal to plain; "
        f"kernel {fmt_times(r)}; plain {r['plain_ms']:.4f} ms; longest walk "
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

    # the Viterbi kernel against its plain version, bitwise: on the DP
    # inputs of the 32 analysis signals, of one budget group of the
    # analysis cell (24 utterances of 3.5 s, the pool's longest bucket; its
    # row's shapes and times), of inputs full of ties and of one utterance
    # of 60 s
    rng_v = np.random.default_rng(args.seed + 13)
    vit_group = viterbi_inputs(a_sigs, dev)
    vit_cell = viterbi_inputs(make_witness_signals(
        rng_v, VITERBI_CELL_GROUP, max(BENCH_POOL_SECONDS))[0], dev)
    vit_long = viterbi_inputs(make_witness_signals(
        rng_v, 1, VITERBI_LONG_SECONDS)[0], dev)
    compared = {
        f"{len(a_sigs)} x {UTT_SECONDS} s": viterbi_equal(vit_group, "group"),
        f"{VITERBI_CELL_GROUP} x {max(BENCH_POOL_SECONDS)} s": viterbi_equal(
            vit_cell, "a budget group of the analysis cell"),
        f"1 x {VITERBI_LONG_SECONDS} s (T={vit_long[0].shape[1]})":
            viterbi_equal(vit_long, "60 s utterance")}
    B_c, T_c, _ = vit_cell[0].shape
    for name, args_t in viterbi_tie_inputs(rng_v, dev, B_c, T_c).items():
        compared[name] = viterbi_equal(args_t, name)
    states = KV.viterbi(*vit_cell)
    vit_bytes, vit_ops = viterbi_work(*vit_cell, states)
    bnd = bound(vit_bytes, vit_ops)
    chain_ns, chain_cycles = viterbi_chain_ns(dev)
    chain_ms = (T_c - 1) * chain_ns * 1e-6
    results["viterbi"] = dict(
        max_abs_err=0.0,
        **kernel_timings(lambda: KV.viterbi(*vit_cell)),
        plain_ms=cuda_ms(lambda: KV.viterbi_plain(*vit_cell), reps=2,
                         warmup=1),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
        chain_bound_ms=chain_ms, chain_ns_per_step=chain_ns,
        group=dict(B=len(a_sigs), T=vit_group[0].shape[1], **kernel_timings(
            lambda: KV.viterbi(*vit_group))))
    r = results["viterbi"]
    t_long = kernel_ms(lambda: KV.viterbi(*vit_long))["median"]
    log(f"[kernels] Viterbi states bitwise equal to plain on "
        f"{'; '.join(f'{k} ({n} frames)' for k, n in compared.items())}")
    log(f"[kernels] Viterbi B={B_c} T={T_c}: kernel {fmt_times(r)}; plain "
        f"{r['plain_ms']:.4f} ms ({r['plain_ms'] / r['ms']:.0f}x); bound "
        f"{r['bound_ms']:.6f} ms ({r['bound_by']}; {vit_bytes} bytes, "
        f"{vit_ops} operations), {r['bound_ms'] / r['ms']:.2%} of it; chain "
        f"probe {chain_ns:.2f} ns, {chain_cycles:.2f} SM cycles a frame "
        f"({VITERBI_PROBE_STEPS} steps), chain bound {chain_ms:.4f} ms "
        f"({T_c - 1} frames), {chain_ms / r['ms']:.1%} of it; "
        f"{r['ms'] * 1e6 / (T_c - 1):.1f} ns a frame; B={len(a_sigs)} "
        f"T={vit_group[0].shape[1]}: {fmt_times(r['group'])}; 60 s "
        f"utterance (B={vit_long[0].shape[0]}, T={vit_long[0].shape[1]}): "
        f"{t_long:.4f} ms cold")
    del vit_group, vit_cell, vit_long, states

    # K5 against its plain version: the forward on the K1 frames of this
    # analysis group at its realised frame bucket, the inverse at the
    # 128-utterance serving geometry
    F_a = min(m_max_a, bucket_frames(n_max_marks))
    # K2 at the geometry of one copy-synthesis group: the synthesis frames
    # (B, F, 4096) of that group's marks, centred on them, into its (B, S +
    # 16384) output
    c_starts = (got[0][:, :F_a] - 2048).to(torch.int32).contiguous()
    c_frm = torch.randn(*c_starts.shape, 4096, device=dev,
                        generator=torch.Generator(dev).manual_seed(
                            args.seed + 1))
    results["ola"]["copy_synthesis"] = check_ola(
        c_frm, c_starts, got[2].to(torch.int32).contiguous(),
        S_a + (1 << 14), "ola at the copy-synthesis geometry")
    del c_frm, c_starts
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
    rel, fails = serving_vs_cpu(wavs8, wavs8_cpu)
    if fails:
        raise AssertionError("CUDA vs CPU request: " + "; ".join(fails))
    log(f"[serve] CUDA vs CPU, 8 utts: max|diff|/peak {rel:.3g} "
        f"(bound {TOL_CUDA_VS_CPU}); CPU took {dt_cpu * 1000:.1f} ms")

    # the noise keys derived from key= (no keys=) on the card, against the
    # same request given split(key, 8) as keys=
    root = prng_key(args.seed)
    by_key, by_keys = (batch.synthesis_from_compressed_batch(
        feats[:8], FS, pf_type="magphase", device=dev, **kw)
        for kw in (dict(key=root), dict(keys=split(root, 8))))
    rel = max(float(np.abs(a - b).max()) for a, b in zip(by_key, by_keys)) \
        / max(float(np.abs(w).max()) for w in by_keys)
    if not rel <= TOL_CUDA_VS_CPU:
        raise AssertionError(f"key= vs keys=split(key, 8): max|diff|/peak "
                             f"{rel:.3g} > {TOL_CUDA_VS_CPU}")
    log(f"[serve] 8 utts by key=prng_key({args.seed}) vs keys=split(key, 8):"
        f" max|diff|/peak {rel:.3g}")

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
    counts_f, facade_checks = run_facade_path(dev, args.seed)
    for name, r in facade_checks.items():
        results[name]["facade"] = r
    counts_c, cli_checks = run_cli_path(dev, args.seed)
    for name, r in cli_checks.items():
        results[name]["cli"] = r
    counts_v, variants_checks = run_variants_path(dev, args.seed, feats,
                                                  keys_all)
    for name, r in variants_checks.items():
        results[name]["variants"] = r
    counts_m, mesh_checks = run_mesh_path(dev, args.seed, feats, keys_all,
                                          a_sigs, a_marks, a_vois)
    for name, r in mesh_checks.items():
        results[name]["mesh"] = r
    counts_mp = run_multiproc_path(dev, args.seed)
    counts_e, example_check = run_example_path(dev, args.seed)
    results["ola"]["example"] = example_check
    run_bench_phase(args.seed)

    if args.profile:
        profile_request(feats, keys_all, dev)
        profile_analysis(a_sigs, dev)
        profile_copy_synthesis(a_sigs, dev)

    launches = {**counts, "walk": counts_a["walk"],
                "viterbi": counts_a["viterbi"],
                "rfft_fused": counts_k5["rfft_fused"],
                "irfft_fused": counts_k5["irfft_fused"]}
    for counts_p in (counts_f, counts_c, counts_v, counts_m, counts_mp,
                     counts_e):
        for name, c in counts_p.items():
            launches[name] += c
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    **{k: r[k] for k in (*TIMING_KEYS, "bytes_bound_ms",
                                         "chain_bound_ms",
                                         "chain_ns_per_step", "group",
                                         "padded_bound_ms", "copy_synthesis",
                                         "facade", "cli", "variants",
                                         "mesh", "example")
                       if k in r})
               for name, r in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
