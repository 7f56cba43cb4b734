"""Command-line interface (port of magphase_tpu/cli.py): the corpus
commands that replace the reference's edit-the-constants batch scripts
(scripts/batch_feature_extraction_for_tts.py,
scripts/batch_waveform_generation.py,
scripts/batch_convert_label_state_aligned_to_variable_frame_rate.py).

Usage:
  python -m magphase_tpu_torch.cli extract  --scp file_id.scp \
      --wav-dir wavs --out-dir feats [--mag-dim 60 --phase-dim 45 \
      --const-rate --batch-size 8 --device cuda]
  python -m magphase_tpu_torch.cli generate --scp file_id.scp \
      --feats-dir feats --out-dir wavs_syn --fs 48000 [--mag-dim 60 \
      --phase-dim 45 --pf-type magphase --const-rate --batch-size 16 \
      --transport int8 --device cuda]
  python -m magphase_tpu_torch.cli convert-labels --scp file_id.scp \
      --shift-dir feats --lab-dir labs --out-dir labs_var
  python -m magphase_tpu_torch.cli eval --scp file_id.scp \
      --ref-dir wavs --cand-dir wavs_syn
  python -m magphase_tpu_torch.cli serve --socket /tmp/mp.sock   # daemon
  python -m magphase_tpu_torch.cli generate ... --server /tmp/mp.sock

The subcommands, flags, defaults, exit codes, manifest and output files
are the JAX CLI's, so a corpus directory may be resumed by either.
``--device`` (default ``cuda``) on extract and generate picks where the
work runs; a command asked for CUDA on a machine without it raises.  The
port runs in one process on one card: ``--data-parallel`` is a no-op with
fewer than two CUDA devices (as the JAX CLI's with fewer than two local
devices) and raises with more, and a multi-process environment raises.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _add_common(p):
    p.add_argument("--scp", required=True, help="utterance token list")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--crash-list", default=None)


def _device(args):
    """The torch device of ``--device``; raises where CUDA is asked for and
    absent (the command must not carry on on the CPU)."""
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available; pass --device cpu to run on the CPU")
    return dev


def _host_partition(tokens, weights_fn=None):
    """This process's token shard and its manifest file name.  The port
    runs single-process: the whole list and the JAX CLI's single-host
    manifest name.  A multi-process environment (the JAX package's
    coordinator variable, or a torch WORLD_SIZE above 1) raises rather
    than writing a corpus that every process would duplicate.
    ``weights_fn`` (per-token durations for multi-host balancing) is not
    called."""
    del weights_fn
    if (os.environ.get("JAX_COORDINATOR_ADDRESS")
            or int(os.environ.get("WORLD_SIZE", "1")) > 1):
        raise RuntimeError("multi-process corpus runs are not supported by "
                           "the port (ROADMAP queue 1 item 8)")
    return tokens, ".magphase_manifest.json"


def _maybe_mesh(flag: bool):
    """None: the port has no device mesh.  ``--data-parallel`` with fewer
    than two CUDA devices is a no-op, as the JAX CLI's with fewer than two
    local devices; with two or more it raises (multi-GPU is ROADMAP queue
    1 item 8)."""
    if not flag:
        return None
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        raise ValueError("--data-parallel over several CUDA devices is not "
                         "ported yet (ROADMAP queue 1 item 8)")
    return None


def cmd_extract(args) -> int:
    from .io import mkdir, read_scp_file, read_wav, read_wav_info, \
        write_featfile
    from .utils.corpus import run_corpus, run_corpus_batched
    from .utils.metrics import setup_logging
    from .vocoder import analysis_for_acoustic_modelling

    device = _device(args)
    setup_logging()
    tokens = read_scp_file(args.scp)
    mkdir(args.out_dir)
    config = {"mag_dim": args.mag_dim, "phase_dim": args.phase_dim,
              "const_rate": args.const_rate}

    if args.batch_size > 1 and not args.no_sort:
        # length-sorted batching: homogeneous chunks share shapes and
        # minimise padding (features are per-utterance deterministic, so
        # ordering is free to change)
        try:
            info = {t: read_wav_info(
                os.path.join(args.wav_dir, t + ".wav")) for t in tokens}
            tokens = sorted(tokens, key=lambda t: info[t][0])
        except Exception:
            # unreadable/corrupt files surface later, where crash-list
            # isolation applies per utterance (read_wav_info can raise
            # ValueError/struct.error, not just OSError)
            pass

    tokens, manifest_name = _host_partition(tokens)
    if args.batch_size > 1:
        _maybe_mesh(args.data_parallel)
        # device-batched production path: the tracker + K4 walk, then K1
        # analysis + compression, per chunk
        from .parallel.analysis_batch import analysis_compressed_batch_async

        def process_batch(chunk):
            # native threaded batch read (C++ decode fan-out, io/native.py);
            # the Python codec stands in where the library cannot be built
            from .io import native as native_io

            paths = [os.path.join(args.wav_dir, tok + ".wav")
                     for tok in chunk]
            max_len = max(read_wav_info(p)[0] for p in paths)
            rows, lens, fss = native_io.batch_read_wavs(paths, max_len)
            sigs = [rows[i, :lens[i]] for i in range(len(chunk))]
            fss = [int(f) for f in fss]
            if len(set(fss)) > 1:
                # mixed-rate chunk: raising here drops the runner into
                # singleton retries, where each file gets its own fs
                raise ValueError(f"mixed sample rates in chunk: {set(fss)}")
            fs = fss[0]
            # work starts now: the runner overlaps the next chunk's wav
            # reads with this chunk's device time
            get_feats = analysis_compressed_batch_async(
                sigs, fs, mag_dim=args.mag_dim, phase_dim=args.phase_dim,
                fft_len=args.fft_len or None,
                b_const_rate=args.const_rate, device=device)

            def finalize():
                for tok, (mml, mrm, mim, lf0, sh) in zip(chunk, get_feats()):
                    write_featfile(mml, args.out_dir, tok + ".mag")
                    write_featfile(mrm, args.out_dir, tok + ".real")
                    write_featfile(mim, args.out_dir, tok + ".imag")
                    write_featfile(lf0, args.out_dir, tok + ".lf0")
                    if not args.const_rate:
                        # const-rate features need no .shift
                        # (analysis_for_acoustic_modelling,
                        # magphase.py:3014-3020)
                        write_featfile(sh.astype("float32"), args.out_dir,
                                       tok + ".shift")
                return [len(s) / fs for s in sigs]

            return finalize

        res = run_corpus_batched(tokens, process_batch, args.out_dir,
                                 batch_size=args.batch_size, config=config,
                                 crash_list_path=args.crash_list,
                                 manifest_name=manifest_name)
        res.metrics.log_summary()
        return 1 if res.failed else 0

    def process(tok):
        wav = os.path.join(args.wav_dir, tok + ".wav")
        analysis_for_acoustic_modelling(
            wav, args.out_dir, fft_len=args.fft_len or None,
            mag_dim=args.mag_dim, phase_dim=args.phase_dim,
            b_const_rate=args.const_rate, device=device)
        sig, fs = read_wav(wav)
        return len(sig) / fs

    res = run_corpus(tokens, process, args.out_dir, config=config,
                     crash_list_path=args.crash_list,
                     manifest_name=manifest_name)
    res.metrics.log_summary()
    return 1 if res.failed else 0


def cmd_generate(args) -> int:
    from .io import mkdir, read_binfile, read_scp_file
    from .parallel import batch as pbatch
    from .utils.corpus import run_corpus, run_corpus_batched
    from .utils.keys import prng_key, split
    from .utils.metrics import setup_logging

    device = _device(args)
    setup_logging()
    tokens = read_scp_file(args.scp)
    mkdir(args.out_dir)
    # per-utterance noise keys by GLOBAL scp index (split is prefix-stable
    # and bit for bit jax.random.split): an utterance's audio does not
    # depend on chunking or batch size, and equals the JAX CLI's keys
    all_keys = split(prng_key(args.seed), max(len(tokens), 1))
    key_of = {tok: all_keys[i] for i, tok in enumerate(tokens)}
    # every output-affecting knob is in the manifest config — a resumed
    # run with ANY of them changed restarts instead of silently mixing
    # differently-rendered wavs in one corpus
    config = {"fs": args.fs, "mag_dim": args.mag_dim,
              "phase_dim": args.phase_dim, "pf_type": args.pf_type,
              "const_rate": args.const_rate, "seed": args.seed,
              "hpf": not args.no_hpf, "transport": args.transport}
    _maybe_mesh(args.data_parallel)
    tokens, manifest_name = _host_partition(tokens)

    def read_utt_feats(tok):
        d = args.feats_dir
        return (read_binfile(os.path.join(d, tok + ".mag"), args.mag_dim),
                read_binfile(os.path.join(d, tok + ".real"),
                             args.phase_dim),
                read_binfile(os.path.join(d, tok + ".imag"),
                             args.phase_dim),
                read_binfile(os.path.join(d, tok + ".lf0"), 1))

    if args.const_rate:
        # constant-rate inputs need the per-utterance backward shift walk
        from .vocoder import synthesis_from_acoustic_modelling

        def process(tok):
            synthesis_from_acoustic_modelling(
                args.feats_dir, tok, args.out_dir, args.mag_dim,
                args.phase_dim, args.fs, pf_type=args.pf_type,
                b_const_rate=True, key=key_of[tok], device=device)

        res = run_corpus(tokens, process, args.out_dir, config=config,
                         crash_list_path=args.crash_list,
                         manifest_name=manifest_name)
        res.metrics.log_summary()
        return 1 if res.failed else 0

    # fast path: the threaded four-stage pipeline (feature reads + batch
    # prep on the feeder thread, upload / execute / PCM16 download + wav
    # write each on their own thread and stream).  Any failure falls back
    # to the chunk-isolating runner below for the unfinished tokens, which
    # keeps the crash-list contract (singleton retries).
    from .io.wav import write_wav_pcm16
    from .utils.corpus import CorpusResult, Manifest
    from .utils.metrics import logger

    manifest = Manifest(args.out_dir, config, manifest_name)
    res = CorpusResult()
    pending = []
    for tok in tokens:
        (res.skipped if tok in manifest.done else pending).append(tok)

    def read_batches(pend, unreadable):
        for i in range(0, len(pend), args.batch_size):
            chunk = pend[i:i + args.batch_size]
            # a missing/corrupt feature file must not tear down the
            # pipeline NOR demote its healthy chunkmates: park only the
            # failing token for the chunk-isolating runner (which
            # singleton-retries + crash-lists it) and keep the rest on
            # the fast path
            utts, good = [], []
            for t in chunk:
                try:
                    utts.append(read_utt_feats(t))
                    good.append(t)
                except Exception:
                    unreadable.append(t)
            if good:
                yield utts, np.stack([key_of[t] for t in good]), good

    def consume(rows, host):
        chunk, start = host["tag"]
        toks = chunk[start:start + host["n_real"]]
        done = []
        for j, tok in enumerate(toks):
            n = host["out_lens"][j]
            write_wav_pcm16(os.path.join(args.out_dir, tok + ".wav"),
                            rows[j][:n], args.fs)
            done.append((tok, n / args.fs))
        return done

    # fast path with bounded retries: unreadable chunks are parked by the
    # feeder without stopping the pipeline; a device-stage failure tears
    # one pipeline down but the NEXT attempt resumes pipelined from the
    # manifest, so one bad chunk costs one retry — not a demotion of the
    # whole remaining corpus to the slow runner
    unreadable: list = []
    for attempt in range(3):
        todo = [t for t in pending
                if t not in manifest.done and t not in unreadable]
        if not todo:
            break
        try:
            with res.metrics.stage("process"):
                for done in pbatch.synthesis_batches_pipelined(
                        read_batches(todo, unreadable), args.fs,
                        pf_type=args.pf_type, b_out_hpf=not args.no_hpf,
                        pcm16=True, consume=consume, det_fft_syn=True,
                        transport=args.transport, device=device):
                    for tok, secs in done:
                        res.metrics.add_audio(float(secs))
                        manifest.mark(tok)
                        res.done.append(tok)
                    manifest.save()
            break
        except Exception as e:
            logger.warning("pipelined generation failed (%s); "
                           "retry %d/2 resumes from the manifest",
                           e, attempt + 1)

    remaining = [t for t in pending if t not in manifest.done]
    if remaining:
        def process_batch(chunk):
            utts = [read_utt_feats(tok) for tok in chunk]
            bufs, lens = pbatch.synthesis_from_compressed_batch(
                utts, args.fs, pf_type=args.pf_type,
                keys=np.stack([key_of[t] for t in chunk]),
                b_out_hpf=not args.no_hpf, block_result=False, pcm16=True,
                det_fft_syn=True, transport=args.transport, device=device)

            def finalize():
                for tok, buf, n in zip(chunk, bufs, lens):
                    write_wav_pcm16(
                        os.path.join(args.out_dir, tok + ".wav"),
                        buf[:n].cpu().numpy(), args.fs)
                return [n / args.fs for n in lens[:len(chunk)]]

            return finalize

        res2 = run_corpus_batched(remaining, process_batch, args.out_dir,
                                  batch_size=args.batch_size,
                                  config=config,
                                  crash_list_path=args.crash_list,
                                  manifest_name=manifest_name)
        res2.metrics.log_summary()
        res.metrics.log_summary()
        return 1 if res2.failed else 0

    res.metrics.log_summary()
    return 0


def cmd_eval(args) -> int:
    """Objective comparison of two corpora: waveform MSD (CALMCD stand-in,
    development/run_merlin_experiment.py:191) or .mag feature distortion
    (development/compare_mags.py)."""
    import json
    from .io import read_binfile, read_scp_file, read_wav
    from .utils.eval import (log_spectral_distortion_feats,
                             mel_spectral_distortion)

    tokens = read_scp_file(args.scp)
    per_utt = {}
    for tok in tokens:
        if args.mode == "wav":
            a, fs = read_wav(os.path.join(args.ref_dir, tok + ".wav"))
            b, fs_b = read_wav(os.path.join(args.cand_dir, tok + ".wav"))
            if fs_b != fs:
                raise ValueError(f"{tok}: sample rate mismatch "
                                 f"(ref {fs}, cand {fs_b})")
            d = mel_spectral_distortion(a, b, fs,
                                        exclude_gain=args.exclude_gain)
        else:
            a = read_binfile(os.path.join(args.ref_dir, tok + ".mag"),
                             args.mag_dim)
            b = read_binfile(os.path.join(args.cand_dir, tok + ".mag"),
                             args.mag_dim)
            d = log_spectral_distortion_feats(a, b)
        per_utt[tok] = round(d, 3)
    mean = sum(per_utt.values()) / max(len(per_utt), 1)
    print(json.dumps({"metric": f"msd_{args.mode}", "mean_db": round(mean, 3),
                      "per_utt": per_utt}))
    return 0


def cmd_convert_labels(args) -> int:
    from .io import mkdir, read_binfile, read_scp_file
    from .io.labels import (convert_label_state_align_to_var_frame_rate,
                            get_num_of_frms_per_state)
    from .utils.corpus import run_corpus
    from .utils.metrics import setup_logging

    setup_logging()
    tokens = read_scp_file(args.scp)
    mkdir(args.out_dir)

    def process(tok):
        v_shift = read_binfile(os.path.join(args.shift_dir, tok + ".shift"),
                               dim=1)
        lab_in = os.path.join(args.lab_dir, tok + ".lab")
        v_nfrms = get_num_of_frms_per_state(v_shift, lab_in, args.fs,
                                            b_prevent_zeros=True)
        convert_label_state_align_to_var_frame_rate(
            lab_in, v_nfrms, os.path.join(args.out_dir, tok + ".lab"))
        return 0.0

    res = run_corpus(tokens, process, args.out_dir,
                     crash_list_path=args.crash_list)
    return 1 if res.failed else 0


def cmd_serve(args) -> int:
    """Persistent daemon: built kernels, cuFFT plans and allocator pools
    stay warm across requests (serve.py)."""
    from .serve import request, serve_forever

    if args.shutdown:
        return request(args.socket, shutdown=True)
    from .utils.metrics import setup_logging
    setup_logging()

    def ready():
        print(f"magphase_tpu_torch serving on {args.socket}", flush=True)

    return serve_forever(args.socket, ready_cb=ready)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    argv = list(argv)
    # `--server SOCK` on any subcommand forwards the invocation to a
    # running `cli serve` daemon (warm process: skips the interpreter and
    # torch start-up, the kernel loads and the first-call allocations)
    if "--server" in argv and (not argv or argv[0] != "serve"):
        i = argv.index("--server")
        if i + 1 >= len(argv):
            sys.stderr.write("--server requires a socket path\n")
            return 2
        from .serve import request
        return request(argv[i + 1], argv[:i] + argv[i + 2:])

    p = argparse.ArgumentParser(prog="magphase_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("extract", help="batch feature extraction for TTS")
    _add_common(pe)
    pe.add_argument("--wav-dir", required=True)
    pe.add_argument("--mag-dim", type=int, default=60)
    pe.add_argument("--phase-dim", type=int, default=45)
    pe.add_argument("--fft-len", type=int, default=0)
    pe.add_argument("--const-rate", action="store_true")
    pe.add_argument("--batch-size", type=int, default=8,
                    help="device batch size (1 = per-utterance path)")
    pe.add_argument("--no-sort", action="store_true",
                    help="keep scp order instead of length-sorted chunks")
    pe.add_argument("--data-parallel", action="store_true",
                    help="shard batches over all local devices (one CUDA "
                    "device: no-op)")
    pe.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:1, cpu)")
    pe.set_defaults(fn=cmd_extract)

    pg = sub.add_parser("generate", help="batch waveform generation")
    _add_common(pg)
    pg.add_argument("--feats-dir", required=True)
    pg.add_argument("--fs", type=int, default=48000)
    pg.add_argument("--mag-dim", type=int, default=60)
    pg.add_argument("--phase-dim", type=int, default=45)
    pg.add_argument("--pf-type", default="magphase",
                    choices=["magphase", "merlin", "no"])
    pg.add_argument("--const-rate", action="store_true")
    pg.add_argument("--no-hpf", action="store_true")
    pg.add_argument("--batch-size", type=int, default=16)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--transport", default="f16", choices=["f16", "int8"],
                    help="feature upload encoding (int8: half the bytes of "
                    "f16, per-utterance-per-coefficient affine uint8)")
    pg.add_argument("--data-parallel", action="store_true",
                    help="shard batches over all local devices (one CUDA "
                    "device: no-op)")
    pg.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, cuda:1, cpu)")
    pg.set_defaults(fn=cmd_generate)

    pv = sub.add_parser("eval", help="objective MSD between two corpora")
    pv.add_argument("--scp", required=True)
    pv.add_argument("--ref-dir", required=True)
    pv.add_argument("--cand-dir", required=True)
    pv.add_argument("--mode", default="wav", choices=["wav", "feats"])
    pv.add_argument("--mag-dim", type=int, default=60)
    pv.add_argument("--exclude-gain", action="store_true")
    pv.set_defaults(fn=cmd_eval)

    pc = sub.add_parser("convert-labels",
                        help="state-aligned labels -> variable frame rate")
    _add_common(pc)
    pc.add_argument("--shift-dir", required=True)
    pc.add_argument("--lab-dir", required=True)
    pc.add_argument("--fs", type=int, default=48000)
    pc.set_defaults(fn=cmd_convert_labels)

    ps = sub.add_parser("serve", help="persistent daemon: run corpus "
                        "commands in one warm process (--server SOCK on "
                        "any subcommand forwards to it)")
    ps.add_argument("--socket", required=True, help="Unix socket path")
    ps.add_argument("--shutdown", action="store_true",
                    help="stop a running daemon instead of starting one")
    ps.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
