"""Scaling-efficiency benchmark: sharded Monte-Carlo chunk over an
N-device batch mesh vs single device.

On a multi-GPU host this reports the scaling efficiency (target: >=90%,
BASELINE.json); with --cpu N it validates the mechanism on a simulated
N-device CPU mesh (no timing meaning).

Usage:
  python scripts/bench_scaling.py                 # all local devices
  python scripts/bench_scaling.py --cpu 8         # simulated CPU mesh
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="simulate an N-device CPU mesh")
    ap.add_argument("--batch-per-device", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)

    sys.path.insert(0, ".")
    from __graft_entry__ import _flagship_code
    from ldpc_decoders_tpu.harness import MonteCarloRunner, RunConfig
    from ldpc_decoders_tpu.parallel import batch_mesh

    import ldpc_decoders_tpu.codes.code as code_mod
    code = _flagship_code()
    code_name = "bench_1200_3_6"
    # Register the flagship parity matrix under a temp name for the runner.
    code_mod.BUILTIN_CODES[code_name] = (None, code.parity_mtx)

    n_dev = len(jax.devices())
    results = {}
    for nd in sorted({1, n_dev}):
        cfg = RunConfig(channel="biawgn", code=code_name, decoder="MSA",
                        params=[3.0], codeword=0, min_wec=10 ** 9,
                        batch=args.batch_per_device * nd,
                        max_words=args.batch_per_device * nd * args.reps,
                        log_freq=1e9, msg_dtype="bfloat16")
        mesh = batch_mesh(nd) if nd > 1 else None
        runner = MonteCarloRunner(cfg, mesh=mesh)
        # Warmup one chunk.
        key = jax.random.PRNGKey(0)
        _ = runner.run_param(3.0, key)
        t0 = time.perf_counter()
        res = runner.run_param(3.0, jax.random.PRNGKey(1))
        dt = time.perf_counter() - t0
        results[nd] = res["tot"] / dt
        print(f"{nd} device(s): {results[nd]:.0f} cw/s")

    if len(results) > 1:
        eff = results[n_dev] / (results[1] * n_dev)
        print(json.dumps({"metric": "scaling_efficiency",
                          "devices": n_dev,
                          "value": round(eff, 3), "unit": "fraction"}))


if __name__ == "__main__":
    main()
