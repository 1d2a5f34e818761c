"""Breadth benchmark: one-GPU throughput for every jit decoder family
(MSA, SPA, BEC-SPA, ADMM, ML) on its benchmark configuration, through
each XLA data-movement route, one JSON line per decoder and route — so
regressions in the non-headline decoders are visible, not just the
headline MSA number bench.py reports. Every line names its device and
card; the script exits non-zero when JAX finds no GPU.

Configurations mirror the reference's campaign workloads
(simulations.py:64-77 REG sweeps for BP on LDPC(1200,3,6);
simulations.py:52-61 HMG for ML; ADMM on the flagship code at its
artifact operating point).

Usage:  python scripts/bench_all.py [--reps N] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def bench_chunk(chunk, reps: int, depth: int = 4):
    """Pipelined steady-state timing of an async one-dispatch chunk fn
    (same discipline as bench.py and the campaign harness: warmup
    excluded, ONE packed tally vector fetched per chunk, the host copy
    started at dispatch time — see runner._start_host_copy)."""
    import numpy as np

    def dispatch(i):
        t = chunk(i)
        t.copy_to_host_async()
        return t

    chunk(0).block_until_ready()
    t0 = time.perf_counter()
    wec = 0
    pending = []
    for i in range(reps):
        pending.append(dispatch(i + 1))
        if len(pending) >= depth:
            wec += int(np.asarray(pending.pop(0))[0])
    for t in pending:
        wec += int(np.asarray(t)[0])
    return time.perf_counter() - t0, wec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="also append JSON lines to this file")
    ap.add_argument("--only", nargs="*", default=None,
                    help="subset of decoder names to run")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ldpc_decoders_tpu.utils.device import (
        NoGPUError,
        card_line,
        require_gpu,
    )
    try:
        device = require_gpu()
    except NoGPUError as e:
        sys.exit(f"bench_all.py: {e}")
    card = card_line()

    from __graft_entry__ import _flagship_code
    from ldpc_decoders_tpu import get_code
    from ldpc_decoders_tpu.channels import bec, biawgn
    from ldpc_decoders_tpu.decoders.admm import ADMMDecoder
    from ldpc_decoders_tpu.decoders.bec_spa import BECSPADecoder
    from ldpc_decoders_tpu.decoders.bp import BPDecoder
    from ldpc_decoders_tpu.decoders.ml import MLBiAWGN

    code = _flagship_code()
    hamming = get_code("7_4_hamming")
    base_key = jax.random.PRNGKey(0)
    specs = []

    def bp_spec(name, variant, batch=16384, **kw):
        dec = BPDecoder(code.graph, variant, max_iter=10,
                        msg_dtype=jnp.bfloat16, **kw)
        x = jnp.zeros((batch, code.get_n()), jnp.int32)

        @jax.jit
        def chunk(i, snr_db=3.0):
            k1, k2 = jax.random.split(jax.random.fold_in(base_key, i))
            y = biawgn.send(k1, x, snr_db)
            x_hat, _ = dec.decode(biawgn.llr(y, snr_db), k2)
            errs = (x_hat != x).sum(axis=-1)
            return jnp.stack([(errs > 0).sum(), errs.sum()])

        return (f"{name}_{dec.perm}",
                f"{variant} it<=10 LDPC(1200,3,6) biAWGN 3dB bf16 "
                f"{dec.perm}", batch, chunk)

    # SPA default = the reference's inf/NaN-cascade semantics (golden
    # parity); "saturate" is the clean policy (docs/PARITY.md).
    for perm in ("incidence", "gather"):
        specs.append(bp_spec("msa", "MSA", perm=perm))
        specs.append(bp_spec("spa", "SPA", perm=perm))
        specs.append(bp_spec("spa_saturate", "SPA", perm=perm,
                             inf_policy="saturate"))

    def becspa_spec(name="bec_spa"):
        dec = BECSPADecoder(code.graph, max_iter=10)
        batch = 16384
        x = jnp.zeros((batch, code.get_n()), jnp.int32)

        @jax.jit
        def chunk(i, eps=0.3):
            k1, k2 = jax.random.split(jax.random.fold_in(base_key, i))
            y = bec.send(k1, x, eps)
            x_hat, _ = dec.decode(y, k2)
            errs = (x_hat != x).sum(axis=-1)
            return jnp.stack([(errs > 0).sum(), errs.sum()])

        return (name, "ternary SPA it<=10 LDPC(1200,3,6) BEC eps=.3 "
                "gather", batch, chunk)

    specs.append(becspa_spec())

    def admm_spec(perm):
        dec = ADMMDecoder(code.graph, mu=3.0, eps=1e-5, max_iter=50,
                          perm=perm)
        batch = 16384
        x = jnp.zeros((batch, code.get_n()), jnp.int32)

        @jax.jit
        def chunk(i, snr_db=3.0):
            k1, k2 = jax.random.split(jax.random.fold_in(base_key, i))
            y = biawgn.send(k1, x, snr_db)
            x_hat, _ = dec.decode(biawgn.llr(y, snr_db), k2)
            errs = (x_hat != x).sum(axis=-1)
            return jnp.stack([(errs > 0).sum(), errs.sum()])

        return (f"admm_{perm}", f"ADMM it<=50 LDPC(1200,3,6) biAWGN 3dB "
                f"{perm}", batch, chunk)

    specs.append(admm_spec("gather"))
    specs.append(admm_spec("matmul"))

    def ml_spec():
        dec = MLBiAWGN(hamming)
        batch = 65536
        x = jnp.zeros((batch, hamming.get_n()), jnp.int32)

        @jax.jit
        def chunk(i, snr_db=3.0):
            k1, k2 = jax.random.split(jax.random.fold_in(base_key, i))
            y = biawgn.send(k1, x, snr_db)
            x_hat = dec.decode(y, snr_db, k2)
            errs = (x_hat != x).sum(axis=-1)
            return jnp.stack([(errs > 0).sum(), errs.sum()])

        return ("ml", "ML codebook Hamming(7,4) biAWGN 3dB", batch, chunk)

    specs.append(ml_spec())

    lines = []
    for name, desc, batch, chunk in specs:
        if args.only and name not in args.only:
            continue
        dt, wec = bench_chunk(chunk, args.reps)
        cw_per_s = args.reps * batch / dt
        line = {"metric": f"decoded_codewords_per_sec_1gpu_{name}",
                "config": desc, "value": cw_per_s,
                "unit": "codewords/s", "wec": wec, "device": device,
                "card": card}
        lines.append(line)
        print(json.dumps(line), flush=True)

    if args.out:
        with open(args.out, "a") as fp:
            for line in lines:
                fp.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
