"""Headline benchmark: decoded codewords/sec, MSA it<=10, LDPC(1200,3,6),
biAWGN 3 dB, full Monte-Carlo step (sample + LLR + decode + tally) on one
GPU.

Prints the card's ``nvidia-smi`` name and power limit, then ONE JSON line
{"metric", "value", "unit", "route", "device"}. Exits non-zero when JAX
finds no GPU: a CPU number is never reported under this metric.

  python bench.py
"""

from __future__ import annotations

import json
import sys
import time


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ldpc_decoders_tpu.utils.device import (
        NoGPUError,
        card_line,
        require_gpu,
    )
    try:
        device = require_gpu()
    except NoGPUError as e:
        sys.exit(f"bench.py: {e}")
    card = card_line()

    from __graft_entry__ import _flagship_code
    from ldpc_decoders_tpu.channels import biawgn
    from ldpc_decoders_tpu.decoders.bp import BPDecoder

    code = _flagship_code()
    # bfloat16 messages: statistically equivalent curves (validated vs the
    # reference goldens) at half the message bytes of float32.
    dec = BPDecoder(code.graph, "MSA", max_iter=10, msg_dtype=jnp.bfloat16)
    batch = 16384
    x = jnp.zeros((batch, code.get_n()), jnp.int32)
    base_key = jax.random.PRNGKey(0)

    @jax.jit
    def chunk(i, snr_db):
        # Key derivation inside jit: the host passes a plain int, so each
        # step is ONE dispatch.
        k1, k2 = jax.random.split(jax.random.fold_in(base_key, i))
        y = biawgn.send(k1, x, snr_db)
        x_hat, _ = dec.decode(biawgn.llr(y, snr_db), k2)
        errs = (x_hat != x).sum(axis=-1)
        # ONE packed tally vector = ONE device->host fetch per chunk, as
        # in the campaign harness (runner._start_host_copy).
        return jnp.stack([(errs > 0).sum(), errs.sum()])

    def dispatch(i, snr_db):
        t = chunk(i, snr_db)
        t.copy_to_host_async()
        return t

    snr = 3.0
    chunk(0, snr).block_until_ready()      # compile + warm up

    # Pipelined loop, like the harness: sync tallies a few chunks behind
    # the dispatch front.
    reps, depth = 30, 4
    t0 = time.perf_counter()
    pending = []
    for i in range(reps):
        pending.append(dispatch(i + 1, snr))
        if len(pending) >= depth:
            np.asarray(pending.pop(0))
    for t in pending:
        np.asarray(t)
    cw_per_s = reps * batch / (time.perf_counter() - t0)

    print(f"# card: {card}")
    print(json.dumps({
        "metric": "decoded_codewords_per_sec_1gpu_msa10_ldpc1200_biawgn3db",
        "value": cw_per_s,
        "unit": "codewords/s",
        "route": dec.perm,
        "device": device,
        "card": card,
    }))


if __name__ == "__main__":
    main()
