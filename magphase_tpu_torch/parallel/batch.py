"""Batched compressed synthesis — the serving path and the pipelined
corpus entry (port of magphase_tpu/parallel/batch.py:
synthesis_from_compressed_batch, synthesis_batches_pipelined,
quantise_feats and the host/device halves behind them).

Utterances are padded into dense (B, frames, ...) tensors exactly as the
JAX package pads them — same batch bucket, frame bucket, output-length
bucket and float16 feature rounding (or the same uint8 codes of the int8
transport) — so both packages compute from the same inputs: host packing
and framing geometry in numpy, then post-filter -> mel-unwarp ->
synthesis core -> spectral high-pass on the given device.  A group runs
as three halves: prepare (numpy), upload, execute; the blocking entry runs
them in turn, the pipelined entry on a thread and a stream each.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import define_alpha, define_crossfade_params, define_fft_len
from ..utils import transfer
from ..utils.keys import prng_key, split
from ..utils.padding import (FRM_STEP, MAX_FRAME_ELEMS, bucket,
                             bucket_signal)
from ..vocoder.compressed import (
    PER_PHASE_TYPES, SynthesisTables, _unwarp_kernel,
    get_num_full_mel_coeffs_from_num_phase_coeffs, max_pitch_sync_framelen,
    synthesis_core_batch, synthesis_fft_len)
from ..vocoder.framerate import truncate_shifts
from ..vocoder.postfilter import post_filter, post_filter_merlin

PF_TYPES = ("no", "magphase", "merlin")
# host-link encodings of the packed feature tensor
TRANSPORTS = ("f16", "int8")


def hpf_mode() -> str:
    """MAGPHASE_HPF_MODE, validated: the form of the 40 Hz output
    high-pass, 'spectral' (the default: a per-bin gain on every frame
    spectrum) or 'blocked' (the reference-faithful FFT convolution of each
    utterance's overlap-added signal in sections of a fixed length).  Any
    other value raises ValueError rather than silently running as
    something else."""
    mode = os.environ.get("MAGPHASE_HPF_MODE", "spectral")
    if mode not in ("spectral", "blocked"):
        raise ValueError(f"MAGPHASE_HPF_MODE={mode!r}: 'spectral' or "
                         "'blocked'")
    return mode


# batch-axis bucketing under the frame-element budget (parallel/mesh.py of
# the JAX package, for a single device)
_BATCH_STEP = 8


def capped_batch_step(max_b: int) -> int:
    """Batch bucket step, capped by the budget-derived batch cap."""
    return min(_BATCH_STEP, max(1, max_b))


def budget_batch_cap(max_b: int) -> int:
    """Round a budget-derived batch cap down so that batch bucketing never
    exceeds it: bucket(n <= cap, capped_batch_step(cap)) <= cap."""
    if max_b >= _BATCH_STEP:
        return (max_b // _BATCH_STEP) * _BATCH_STEP
    return max(1, max_b)


def _fused_batch_impl(feats, voi, pm, shifts, nfrms, ns_len, keys,
                      q_scale=None, q_zp=None, *,
                      fs, fft_len, alpha, alpha_phase, mag_dim, phase_dim,
                      mag_dim_ph, b_voi_ap_win, per_phase_type, out_len_max,
                      b_out_hpf, hpf_mode, pf_type, tables):
    """[post-filter] -> mel-unwarp -> synthesis core [+ the 40 Hz output
    high-pass in ``hpf_mode``] for the whole batch (magphase.py:825-997 +
    3259-3268).
    feats (B, F, mag+2*phase) float16, or uint8 codes with their (B, D)
    float32 ``q_scale`` and ``q_zp`` (the int8 transport, quantise_feats);
    keys (B, 2) uint32 values.  All compute is float32."""
    B, F, _D = feats.shape
    h = fft_len // 2 + 1
    feats = feats.to(torch.float32)
    if q_scale is not None:
        feats = feats * q_scale[:, None, :] + q_zp[:, None, :]
    mag_mel = feats[..., :mag_dim].reshape(B * F, mag_dim)
    real_mel = feats[..., mag_dim:mag_dim + phase_dim].reshape(B * F,
                                                              phase_dim)
    imag_mel = feats[..., mag_dim + phase_dim:].reshape(B * F, phase_dim)

    if pf_type == "magphase":
        mag_mel = post_filter(mag_mel, fs,
                              tables=(tables.pf_avg_t, tables.pf_tilt))
    elif pf_type == "merlin":
        mag_mel = post_filter_merlin(mag_mel, fs)

    m_mag, m_real, m_imag = _unwarp_kernel(
        mag_mel, real_mel, imag_mel, fft_len=fft_len, mag_dim_ph=mag_dim_ph,
        alpha=alpha, alpha_phase=alpha_phase, tables=tables)
    return synthesis_core_batch(
        m_mag.reshape(B, F, h), m_real.reshape(B, F, h),
        m_imag.reshape(B, F, h), voi, pm, shifts, nfrms, ns_len, keys,
        fs=fs, fft_len=fft_len, alpha=alpha, b_voi_ap_win=b_voi_ap_win,
        per_phase_type=per_phase_type, out_len_max=out_len_max,
        out_hpf=hpf_mode if b_out_hpf else None, tables=tables)


def quantise_feats(feats16: np.ndarray, nfrms: np.ndarray):
    """Per-(utterance, coefficient) affine uint8 quantisation of the
    packed (B, F, D) float16 feature tensor — the int8 transport encoding
    (half the bytes of float16), in numpy as in the JAX package, so both
    packages dequantise the same codes.

    The affine range is computed over each utterance's VALID rows only
    (padding rows dequantise to arbitrary in-range values; every consumer
    masks frames >= nfrms).  Max dequantisation error is scale/2 =
    range/510 per coefficient.  Returns (q (B, F, D) uint8, scale (B, D)
    f32, zp (B, D) f32).
    """
    B, F, D = feats16.shape
    x = feats16.astype(np.float32)
    valid = np.arange(F)[None, :, None] < nfrms[:, None, None]
    big = np.float32(np.finfo(np.float32).max)
    lo = np.min(np.where(valid, x, big), axis=1)
    hi = np.max(np.where(valid, x, -big), axis=1)
    lo = np.minimum(lo, hi)                      # empty guard
    scale = (hi - lo) / 255.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint((x - lo[:, None, :]) / scale[:, None, :]),
                0, 255).astype(np.uint8)
    return q, scale, lo.astype(np.float32)


def _pcm16_kernel(bufs: torch.Tensor, lens: torch.Tensor,
                  norm: float = 0.98) -> torch.Tensor:
    """Peak-normalised PCM16 encode of (B, O) OLA buffers, on their device
    (write_audio_file + write_wav of io/wav.py: peak over the valid length,
    scale to ``norm``, round half to even, clip)."""
    O = bufs.shape[1]
    mask = torch.arange(O, device=bufs.device)[None, :] < lens[:, None]
    x = torch.where(mask, bufs, 0.0)
    peak = torch.amax(torch.abs(x), dim=1, keepdim=True)
    # a true division (torch computes scalar / tensor as a reciprocal times
    # the scalar, which rounds twice)
    scale = torch.full_like(peak, norm) / torch.clamp(peak, min=1e-30)
    x = x * torch.where(peak > 0, scale, 1.0)
    q = torch.clamp(torch.round(x * 32768.0), -32768, 32767)
    return q.to(torch.int16)


def _synthesis_geometry(utts, fs: int, fft_len: int, det_fft_syn: bool):
    """(fft_syn, max_b) for one synthesis call: the adaptive synthesis FFT
    (or the fixed 50 Hz worst case with ``det_fft_syn``) and the batch cap
    of the frame-element budget."""
    if det_fft_syn:
        framelen_call = 2 * int(fs / 50.0) + 1
    else:
        framelen_call = max(
            max_pitch_sync_framelen(
                (fs / np.where(f0 == 0.0, 200.0, f0)).astype(np.int64))
            for f0 in (np.exp(np.atleast_1d(np.squeeze(np.asarray(
                u[3], np.float64)))) for u in utts))
    fft_syn = synthesis_fft_len(fft_len, framelen_call)
    F_est = bucket(max(np.atleast_1d(np.squeeze(u[3])).shape[0]
                       for u in utts), FRM_STEP)
    max_b = budget_batch_cap(max(1, int(MAX_FRAME_ELEMS // (F_est * fft_syn))))
    return fft_syn, max_b


def _prepare_synthesis_group(utts, *, n_real, keys, max_b, fs, mag_dim,
                             phase_dim, transport="f16"):
    """Host half of one synthesis group: batch-axis bucketing (dummy
    2-frame unvoiced utterances, dropped on return), float16 feature
    packing (uint8 codes with their scale and zero point for the int8
    ``transport``) and vectorised float64 framing geometry.  Pure numpy:
    safe on a feeder thread."""
    B = bucket(n_real, capped_batch_step(max_b))
    if B > n_real:
        dummy = (np.full((2, mag_dim), -3.0, np.float32),
                 np.zeros((2, phase_dim), np.float32),
                 np.zeros((2, phase_dim), np.float32),
                 np.full(2, -1.0e10))
        utts = list(utts) + [dummy] * (B - n_real)

    nfrms = np.asarray([np.atleast_1d(np.squeeze(u[3])).shape[0]
                        for u in utts], np.int64)
    F = bucket(int(nfrms.max()), FRM_STEP)
    D = mag_dim + 2 * phase_dim

    # float16 packing, as the JAX package does it: both packages then
    # compute from the same rounded features
    feats = np.zeros((B, F, D), np.float16)
    lf0_b = np.full((B, F), -1.0e10)
    for b, (mag, real, imag, lf0) in enumerate(utts):
        n = nfrms[b]
        feats[b, :n, :mag_dim] = np.atleast_2d(mag)
        feats[b, :n, mag_dim:mag_dim + phase_dim] = np.atleast_2d(real)
        feats[b, :n, mag_dim + phase_dim:] = np.atleast_2d(imag)
        lf0_b[b, :n] = np.squeeze(np.asarray(lf0, np.float64))

    # f0 == 0 -> 200 Hz, the 5 ms unvoiced rate (magphase.py:2210-2215)
    v_f0 = np.exp(lf0_b)
    voi_b = v_f0 > 1.0
    shifts_b = truncate_shifts(fs / np.where(v_f0 == 0.0, 200.0, v_f0))
    pm_b = np.cumsum(shifts_b, axis=1)
    rows = np.arange(B)
    last = pm_b[rows, nfrms - 1]
    prev = pm_b[rows, np.maximum(nfrms - 2, 0)]
    ns_lens = last + (last - prev)
    out_lens = (ns_lens + 1).tolist()

    q_scale = q_zp = None
    if transport == "int8":
        feats, q_scale, q_zp = quantise_feats(feats, nfrms)
    elif transport != "f16":
        raise ValueError(f"unknown transport {transport!r}")
    keys_b = np.zeros((B, 2), np.uint32)
    keys_b[:n_real] = keys[:n_real]         # dummy rows: outputs dropped
    return dict(feats=feats, voi=voi_b.astype(np.float32),
                pm=pm_b.astype(np.int32), shifts=shifts_b.astype(np.int32),
                nfrms=nfrms.astype(np.int32), ns_lens=ns_lens.astype(np.int32),
                keys=keys_b, q_scale=q_scale, q_zp=q_zp, out_lens=out_lens,
                n_real=n_real, O=bucket_signal(int(max(out_lens))))


def _upload_synthesis_group(host: dict, device, stream=None) -> dict:
    """Device half 1: the group's operands on ``device`` (through pinned
    buffers on ``stream`` on a card, utils/transfer.py); returns them with
    the event after their copies."""
    names = ["feats", "voi", "pm", "shifts", "nfrms", "ns_lens"]
    arrays = [host[n] for n in names]
    arrays.append(host["keys"].astype(np.int64))
    arrays.append(np.asarray(host["out_lens"], np.int64))
    if host["q_scale"] is not None:
        arrays += [host["q_scale"], host["q_zp"]]
    t, event = transfer.upload(arrays, device, stream)
    extra = tuple(t[8:]) if host["q_scale"] is not None else (None, None)
    return dict(args=tuple(t[:7]), lens=t[7], extra=extra, event=event,
                host=host)


def _group_tables(cfg: dict, device) -> SynthesisTables:
    """The constant tables of a synthesis configuration on ``device``."""
    return SynthesisTables(
        fs=cfg["fs"], fft_len=cfg["fft_len"], alpha=cfg["alpha"],
        alpha_phase=cfg["alpha_phase"], mag_dim=cfg["mag_dim"],
        mag_dim_ph=cfg["mag_dim_ph"], pf_type=cfg["pf_type"],
        out_hpf=cfg["hpf_mode"] if cfg["b_out_hpf"] else None).to(device)


def _execute_synthesis_group(dev: dict, cfg: dict, tables, *,
                             pcm16: bool) -> torch.Tensor:
    """Device half 2: the fused synthesis of the group (+ the device PCM16
    encode), on the calling thread's current stream.  Returns the (B, O)
    buffers."""
    bufs = _fused_batch_impl(*dev["args"], *dev["extra"],
                             out_len_max=dev["host"]["O"], tables=tables,
                             **cfg)
    if pcm16:
        bufs = _pcm16_kernel(bufs, dev["lens"])
    return bufs


def _check_synthesis_options(transport, mesh, pf_type,
                             per_phase_type) -> None:
    if transport not in TRANSPORTS:
        raise ValueError(f"transport={transport!r}: expected one of "
                         f"{TRANSPORTS}")
    if mesh is not None:
        raise ValueError("mesh must be None: multi-device synthesis is not "
                         "supported")
    if pf_type not in PF_TYPES:
        raise ValueError(f"pf_type={pf_type!r}: expected one of {PF_TYPES}")
    if per_phase_type not in PER_PHASE_TYPES:
        raise ValueError(per_phase_type)
    hpf_mode()


def _synthesis_config(utts, fs, fft_syn, alpha, alpha_phase, b_voi_ap_win,
                      per_phase_type, b_out_hpf, pf_type) -> dict:
    """The keyword arguments of _fused_batch_impl that a call fixes."""
    mag_dim = np.atleast_2d(utts[0][0]).shape[1]
    phase_dim = np.atleast_2d(utts[0][1]).shape[1]
    mag_dim_ph = get_num_full_mel_coeffs_from_num_phase_coeffs(
        define_crossfade_params(fs)[0], phase_dim, alpha_phase, fs)
    return dict(fs=fs, fft_len=fft_syn, alpha=alpha, alpha_phase=alpha_phase,
                mag_dim=mag_dim, phase_dim=phase_dim, mag_dim_ph=mag_dim_ph,
                b_voi_ap_win=b_voi_ap_win, per_phase_type=per_phase_type,
                b_out_hpf=b_out_hpf, hpf_mode=hpf_mode(), pf_type=pf_type)


def synthesis_from_compressed_batch(utts, fs: int,
                                    fft_len: int | None = None,
                                    b_voi_ap_win: bool = True,
                                    per_phase_type: str = "magphase",
                                    alpha_phase: float | None = None,
                                    b_out_hpf: bool = True,
                                    pf_type: str = "no",
                                    key=None, mesh=None,
                                    block_result: bool = True,
                                    pcm16: bool = False,
                                    transport: str = "f16",
                                    keys=None,
                                    det_fft_syn: bool = False,
                                    *, device="cuda"):
    """Batch synthesis from compressed features.

    utts: list of (m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0) numpy
    tuples.  ``key``: the (2,) uint32 root noise key (a
    ``jax.random.PRNGKey`` value; ``utils.keys.prng_key(0)`` when None);
    the per-utterance keys are ``utils.keys.split(key, len(utts))``, bit
    for bit what the JAX package derives, and prefix-stable, so an
    utterance's audio does not depend on how the call splits the batch.
    ``keys``: explicit (len(utts), 2) uint32 per-utterance keys, which
    override ``key`` (corpus drivers derive them from the global utterance
    index).  ``device``: where the work runs (``"cuda"`` by default;
    ``"cpu"``, ``"cuda:1"``, ...).

    Returns a list of float64 numpy waveforms, or with
    ``block_result=False`` the (B, O) float32 buffer tensor on ``device``
    and the per-utterance lengths (a list of row tensors when the batch
    was split under the frame-element budget).  ``pcm16`` (with
    ``block_result=False``) peak-normalises and quantises the buffers to
    int16 on the device.  ``transport``: the packed features' encoding,
    "f16" or "int8" (per-(utterance, coefficient) affine uint8 codes,
    quantise_feats); compute is float32 either way.  ``det_fft_syn``
    fixes the synthesis FFT at the 50 Hz worst case, independent of batch
    content.

    ``MAGPHASE_HPF_MODE``: 'spectral' (the default) or 'blocked' (hpf_mode);
    with 'blocked', ``det_fft_syn`` and per-utterance keys, every output
    sample of an utterance is independent of the batch it is in.
    ``mesh=None`` only.  Anything else raises ValueError.
    """
    if pcm16 and block_result:
        raise ValueError("pcm16=True is a device transfer encoding; use "
                         "block_result=False")
    _check_synthesis_options(transport, mesh, pf_type, per_phase_type)
    if keys is None:
        keys = split(prng_key(0) if key is None else key, len(utts))
    keys = np.asarray(keys, np.uint32)
    if keys.shape != (len(utts), 2):
        raise ValueError(f"keys shape {keys.shape}, expected "
                         f"({len(utts)}, 2)")
    device = torch.device(device)
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha

    fft_syn, max_b = _synthesis_geometry(utts, fs, fft_len, det_fft_syn)
    if len(utts) > max_b:
        out, rows, lens_all = [], [], []
        for i in range(0, len(utts), max_b):
            r = synthesis_from_compressed_batch(
                utts[i:i + max_b], fs, fft_len=fft_len,
                b_voi_ap_win=b_voi_ap_win, per_phase_type=per_phase_type,
                alpha_phase=alpha_phase, b_out_hpf=b_out_hpf,
                pf_type=pf_type, block_result=block_result, pcm16=pcm16,
                transport=transport, keys=keys[i:i + max_b],
                det_fft_syn=det_fft_syn, device=device)
            if block_result:
                out.extend(r)
            else:
                bufs_g, lens_g = r
                rows.extend(bufs_g[j] for j in range(len(lens_g)))
                lens_all.extend(lens_g)
        return out if block_result else (rows, lens_all)

    cfg = _synthesis_config(utts, fs, fft_syn, alpha, alpha_phase,
                            b_voi_ap_win, per_phase_type, b_out_hpf, pf_type)
    host = _prepare_synthesis_group(
        utts, n_real=len(utts), keys=keys, max_b=max_b, fs=fs,
        mag_dim=cfg["mag_dim"], phase_dim=cfg["phase_dim"],
        transport=transport)
    dev = _upload_synthesis_group(host, device)
    bufs = _execute_synthesis_group(dev, cfg, _group_tables(cfg, device),
                                    pcm16=pcm16)
    out_lens = host["out_lens"]
    n_real = host["n_real"]
    if not block_result:
        return bufs, out_lens[:n_real]
    bufs = bufs.cpu().numpy()
    return [np.asarray(bufs[i][:out_lens[i]], np.float64)
            for i in range(n_real)]


def synthesis_batches_pipelined(batches, fs: int,
                                fft_len: int | None = None,
                                b_voi_ap_win: bool = True,
                                per_phase_type: str = "magphase",
                                alpha_phase: float | None = None,
                                b_out_hpf: bool = True,
                                pf_type: str = "no",
                                mesh=None, pcm16: bool = False,
                                transport: str = "f16",
                                consume=None,
                                det_fft_syn: bool = True,
                                *, device="cuda"):
    """Threaded four-stage corpus synthesis: prepare -> upload -> execute
    -> download, one thread per stage (utils/pipeline.py:run_staged) and,
    on a card, one CUDA stream per device stage (utils/transfer.py), so a
    group's upload and the previous group's download overlap the current
    group's kernels.

    ``batches``: iterable of (utts, keys[, tag]) with utts as in
    synthesis_from_compressed_batch, keys a (len(utts), 2) uint32
    per-utterance key array, and ``tag`` an opaque value handed back as
    ``host['tag'] = (tag, first_utt_index)`` for corpus attribution.
    Yields one result per device GROUP (a batch may split into several
    groups under the frame-element budget), in order: ``consume(bufs,
    host)`` if given, run on the download thread, with ``bufs`` the
    group's real rows on the host, each cut to its valid length (int16
    with ``pcm16``, else float32), and ``host['out_lens']`` those lengths;
    else the float64 waveform list.

    ``det_fft_syn`` defaults to True HERE (unlike the blocking entry): the
    geometry is computed per caller-supplied batch, so with an adaptive
    FFT the output would depend on how the caller chunks batches.  Each
    group goes through the same halves as the blocking entry, so a group's
    output equals synthesis_from_compressed_batch's for the same
    utterances, keys and det_fft_syn.  A stage that raises tears the
    pipeline down and re-raises here.  Options as the blocking entry's;
    ``device``: where the work runs.
    """
    _check_synthesis_options(transport, mesh, pf_type, per_phase_type)
    device = torch.device(device)
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    legs = transfer.Legs(device)
    tables = {}                 # per configuration, on the execute thread

    def gen_groups():
        for batch in batches:
            utts, keys = batch[0], batch[1]
            tag = batch[2] if len(batch) > 2 else None
            keys = np.asarray(keys, np.uint32).reshape(len(utts), 2)
            fft_syn, max_b = _synthesis_geometry(utts, fs, fft_len,
                                                 det_fft_syn)
            cfg = _synthesis_config(utts, fs, fft_syn, alpha, alpha_phase,
                                    b_voi_ap_win, per_phase_type, b_out_hpf,
                                    pf_type)
            for i in range(0, len(utts), max_b):
                part = utts[i:i + max_b]
                host = _prepare_synthesis_group(
                    part, n_real=len(part), keys=keys[i:i + max_b],
                    max_b=max_b, fs=fs, mag_dim=cfg["mag_dim"],
                    phase_dim=cfg["phase_dim"], transport=transport)
                host["tag"] = (tag, i)
                host["cfg"] = cfg
                yield host

    def upload(host):
        return _upload_synthesis_group(host, device, legs.upload)

    def execute(dev):
        cfg = dev["host"]["cfg"]
        with transfer.on(legs.compute):
            transfer.adopt(dev["args"] + dev["extra"] + (dev["lens"],),
                           legs.compute, dev["event"])
            key = tuple(sorted(cfg.items()))
            if key not in tables:
                tables[key] = _group_tables(cfg, device)
            bufs = _execute_synthesis_group(dev, cfg, tables[key],
                                            pcm16=pcm16)
            return bufs, dev["host"], transfer.record(legs.compute)

    def download(x):
        bufs, host, event = x
        rows = transfer.rows_to_host(bufs, host["out_lens"][:host["n_real"]],
                                     legs.download, event)
        if consume is not None:
            return consume(rows, host)
        return [np.asarray(r, np.float64) for r in rows]

    from ..utils.pipeline import run_staged
    yield from run_staged(gen_groups(), [upload, execute, download])
