"""Statistical check: golden-scale LT through the DENSE peel engine,
many sims, mean/std vs the reference golden
(luby-10000-12000-0.01-0.5.json: mean 10606.4, std 425.2, 2750 sims).

The engines are bit-identical per sim (test_dense_engine_matches_sparse)
so this is belt-and-braces — a large draw through the dense path landing
inside the golden's Monte-Carlo band. Host graph sampling overlaps the
previous batch's device decode (same pattern as the CLI).

    python scripts/lt_dense_stat_check.py --sims 512 [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sims", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--k", type=int, default=10000)
    ap.add_argument("--n", type=int, default=12000)
    ap.add_argument("--c", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np

    from ldpc_decoders_tpu.fountain.lt import LTSimulator, stream_batches

    sim = LTSimulator(args.k, args.n, args.c, 0.5, engine="dense")
    rng = np.random.default_rng(args.seed)
    vals: list[int] = []
    t0 = time.time()
    for res in stream_batches(sim, rng, args.sims, args.batch):
        vals.extend(int(r) for r in res)
        print(f"# sims={len(vals)} mean={np.mean(vals):.1f} "
              f"std={np.std(vals):.1f}", flush=True)
    dt = time.time() - t0
    arr = np.asarray(vals, float)
    line = {"k": args.k, "c": args.c, "engine": "dense", "sims": len(vals),
            "batch": args.batch, "seed": args.seed,
            "wall_s": round(dt, 1), "s_per_sim": round(dt / len(vals), 3),
            "mean": round(float(arr.mean()), 1),
            "std": round(float(arr.std()), 1),
            "tail_ge_10800": round(float((arr >= 10800).mean()), 4),
            "golden": {"mean": 10606.4, "std": 425.2, "sims": 2750}}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as fp:
            fp.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
