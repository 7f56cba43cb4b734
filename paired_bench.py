"""Paired benchmark runs of two trees of the repository on one card.

    python3 paired_bench.py --parent DIR --change DIR --cell NAME
                            [--pairs N] [--seed0 S] [--out FILE]

Runs ``bench_torch/run.py --seed S --cell NAME`` of each tree, in turns:
pair i uses seed S + i for both sides, the parent first in even pairs and
the change first in odd ones, each run a process of its own from its
tree's root.  Every run's cell line goes to ``--out`` (JSON lines).  Then
one summary line per end-to-end metric of the cell, by the directions and
bounds of the change's BENCHMARK.json: each side's median and quartiles,
the pairs the change wins (ties count for neither), the change's median
over the parent's, and whether the change wins at least nine tenths of
the pairs by more than the distance between the parent's quartiles (a
gain), or is worse than the parent's median by more than the bound (a
regression).  Per-layer metrics of the traced runs are summarised by
their medians.  Exits 1 if any run failed or any check of it did not
hold.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def run_cell(root: str, cell: str, seed: int) -> dict:
    """One benchmark process of the tree at ``root``: its cell line, with
    the exit code and the process's wall seconds."""
    cmd = [sys.executable, os.path.join(root, "bench_torch", "run.py"),
           "--seed", str(seed), "--cell", cell]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=1200)
    wall = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    cells = [ln for ln in lines if ln.get("cell") == cell]
    if res.returncode != 0 or len(cells) != 1:
        sys.stderr.write(res.stderr[-4000:])
    line = cells[0] if cells else {}
    return dict(line, rc=res.returncode, process_s=wall)


def quartiles(x) -> list:
    return [float(v) for v in np.percentile(x, [25, 50, 75])]


def summarise(runs: list, cell: str, spec: dict) -> list:
    """Summary lines of the pairs in ``runs`` (dicts with side, pair and
    the cell line), one per end-to-end metric, then one of the per-layer
    medians."""
    out = []
    by_side = {s: {r["pair"]: r for r in runs if r["side"] == s}
               for s in ("parent", "change")}
    pairs = sorted(set(by_side["parent"]) & set(by_side["change"]))
    for m in spec["metrics"]["end_to_end"]:
        if cell not in m["workloads"]:
            continue
        name, higher = m["name"], m["direction"] == "higher"
        p = [by_side["parent"][i]["metrics"][name] for i in pairs]
        c = [by_side["change"][i]["metrics"][name] for i in pairs]
        wins = sum((ci > pi) if higher else (ci < pi)
                   for pi, ci in zip(p, c))
        qp, qc = quartiles(p), quartiles(c)
        spread = qp[2] - qp[0]
        gain = (wins >= 0.9 * len(pairs)
                and abs(qc[1] - qp[1]) > spread
                and ((qc[1] > qp[1]) if higher else (qc[1] < qp[1])))
        bound = m["bound"][cell]
        if name == "failed_share":
            worse = max(c) > bound
        else:
            rel = ((qp[1] - qc[1]) / qp[1] if higher
                   else (qc[1] - qp[1]) / qp[1]) if qp[1] else 0.0
            worse = rel > bound
        out.append(dict(cell=cell, metric=name, pairs=len(pairs),
                        parent=p, change=c, parent_quartiles=qp,
                        change_quartiles=qc, change_wins=wins,
                        change_over_parent=(qc[1] / qp[1] if qp[1]
                                            else None),
                        gain=gain, regression=worse, bound=bound))
    layer = {}
    for side in ("parent", "change"):
        keys = sorted({k for i in pairs
                       for k in by_side[side][i]["metrics"]
                       if k.startswith(("device_", "launches_"))})
        layer[side] = {k: float(np.median([by_side[side][i]["metrics"][k]
                                           for i in pairs]))
                       for k in keys}
    out.append(dict(cell=cell, per_layer_medians=layer))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed0", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    roots = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    with open(os.path.join(roots["change"], "BENCHMARK.json")) as f:
        spec = json.load(f)
    runs, ok = [], True
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            line = run_cell(roots[side], args.cell, args.seed0 + i)
            run = {**line, "side": side, "pair": i, "seed": args.seed0 + i}
            runs.append(run)
            good = run["rc"] == 0 and run.get("correct") is True
            ok &= good
            m = run.get("metrics", {})
            print(json.dumps(dict(
                side=side, pair=i, seed=run["seed"], rc=run["rc"],
                correct=run.get("correct"),
                process_s=round(run["process_s"], 1),
                **{k: m.get(k) for k in (
                    "throughput_audio_s_per_s", "latency_ms_p50",
                    "peak_mem_gib", "failed_share", "device_idle_share",
                    "launches_per_request.kernels")})), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(run) + "\n")
    good_runs = [r for r in runs if r["rc"] == 0 and "metrics" in r]
    for ln in summarise(good_runs, args.cell, spec):
        print(json.dumps(ln), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
