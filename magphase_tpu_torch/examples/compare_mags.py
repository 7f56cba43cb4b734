"""Compare two magnitude feature files (counterpart of
examples/compare_mags.py; reference: development/compare_mags.py):
difference statistics and optional heatmaps.

Run:  python -m magphase_tpu_torch.examples.compare_mags ref.mag cand.mag
      [--dim 60] [--log] [--plot-dir out/] [--device cuda]
The differences are computed on ``--device``; the heatmaps need
matplotlib.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..io import read_binfile
from ..utils.eval import log_spectral_distortion_feats
from . import _common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ref")
    ap.add_argument("cand")
    ap.add_argument("--dim", type=int, default=60)
    ap.add_argument("--log", action="store_true",
                    help="inputs are already log-domain")
    ap.add_argument("--plot-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = _common.device(args.device)

    a = np.atleast_2d(read_binfile(args.ref, dim=args.dim))
    b = np.atleast_2d(read_binfile(args.cand, dim=args.dim))
    n = min(len(a), len(b))
    if len(a) != len(b):
        print(f"frame count differs: {len(a)} vs {len(b)}; comparing {n}")
    la_, lb = (torch.from_numpy(np.ascontiguousarray(x[:n], np.float64))
               .to(device) for x in (a, b))
    if not args.log:
        la_, lb = (torch.log(torch.clamp(x, min=1e-10)) for x in (la_, lb))

    d_db = 20.0 / np.log(10.0) * (la_ - lb)
    print(f"frames={n} dim={a.shape[1]}")
    print(f"mean |diff|  : {float(torch.mean(torch.abs(d_db))):8.3f} dB")
    print(f"max  |diff|  : {float(torch.max(torch.abs(d_db))):8.3f} dB")
    rms = torch.mean(torch.sqrt(torch.mean(d_db ** 2, dim=1)))
    print(f"per-frame RMS: {float(rms):8.3f} dB")
    la_, lb, d_db = (x.cpu().numpy() for x in (la_, lb, d_db))
    print(f"MSD (MCD-style): {log_spectral_distortion_feats(la_, lb):8.3f} dB")

    if args.plot_dir:
        from ..utils.plotting import plotm
        os.makedirs(args.plot_dir, exist_ok=True)
        plotm(la_, out_file=os.path.join(args.plot_dir, "ref.png"))
        plotm(lb, out_file=os.path.join(args.plot_dir, "cand.png"))
        plotm(d_db, out_file=os.path.join(args.plot_dir, "diff_db.png"))
        print("plots ->", args.plot_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
