"""Harness-route throughput: what a CAMPAIGN actually gets per GPU.

bench.py / bench_all.py time hand-built decoder chunks; this script
times MonteCarloRunner itself (sampling + decode + tallies + adaptive
loop) on the flagship campaign workloads, through the routes "auto"
selects. Every line names its device and card; the script exits
non-zero when JAX finds no GPU.

Usage:  python scripts/bench_harness.py [--words N] [--out FILE]
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
    ap.add_argument("--words", type=int, default=500_000,
                    help="words per measurement point")
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()

    from ldpc_decoders_tpu.harness import MonteCarloRunner, RunConfig
    from ldpc_decoders_tpu.utils.device import (
        NoGPUError,
        card_line,
        require_gpu,
    )
    try:
        device = require_gpu()
    except NoGPUError as e:
        sys.exit(f"bench_harness.py: {e}")
    card = card_line()

    # (name, cfg kwargs) — campaign operating points (def_cases params).
    CASES = [
        ("biawgn_msa", dict(channel="biawgn", decoder="MSA", params=[3.0],
                            codeword=1, batch=16384,
                            msg_dtype="bfloat16")),
        ("biawgn_spa_ref", dict(channel="biawgn", decoder="SPA",
                                params=[3.0], codeword=0, batch=8192,
                                msg_dtype="bfloat16")),
        ("bec_spa", dict(channel="bec", decoder="SPA", params=[0.3],
                         codeword=0, batch=16384)),
        ("bsc_msa_f32", dict(channel="bsc", decoder="MSA", params=[0.06],
                             codeword=1, batch=16384)),
        ("bsc_spa_ref_f32", dict(channel="bsc", decoder="SPA",
                                 params=[0.06], codeword=0, batch=8192)),
        ("admm", dict(channel="biawgn", decoder="ADMM", params=[3.0],
                      codeword=1, batch=16384, max_iter=50)),
        ("mar_admm", dict(channel="bsc", code="margulis", decoder="ADMM",
                          params=[0.06], codeword=1, batch=2048,
                          max_iter=200, words=20_480)),
    ]

    lines = []
    for name, kw in CASES:
        if args.only and name not in args.only:
            continue
        local = dict(kw)
        code = local.pop("code", "1200_3_6_ldpc")
        words = local.pop("words", args.words)
        cfg = RunConfig(code=code, min_wec=10 ** 9, max_words=words,
                        log_freq=1e9, max_iter=local.pop("max_iter", 10),
                        **local)
        runner = MonteCarloRunner(cfg)
        t0 = time.time()
        res = runner.run()[cfg.params[0]]
        wall = time.time() - t0
        route = getattr(getattr(runner.dec, "dec", None), "perm", "?")
        line = {"metric": f"harness_words_per_sec_{name}",
                "route": route, "value": res["words_per_sec"],
                "unit": "codewords/s", "tot": res["tot"],
                "wall_s": wall, "device": device, "card": card}
        lines.append(line)
        print(json.dumps(line), flush=True)

    if args.out:
        with open(args.out, "a") as fp:
            for line in lines:
                fp.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
