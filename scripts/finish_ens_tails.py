"""Finish the REG_ENS member tail points (eps = 0.31, 0.3) per member.

The joint EnsembleMonteCarloRunner is the right tool for the broad part
of the sweep (one compilation, all members), but at the deep-tail points
the per-word cost matters more than compile time, and a single-member
decode does far less work per word than the G=10 joint program.  The
reference spent
~0.8-1.1M words per member at eps=0.31 and ~4.6-4.9M at eps=0.3
(data/output/bec-1200_3_6_rand_ldpc_*-SPA-10-0.json), so the tails are
per-member work by construction: 10 members x 6M words ~ a few minutes
of decode.

Merges into the existing artifacts/data JSONs (Saver reload-merge keeps
the broad-sweep points).
"""

import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ldpc_decoders_tpu.harness import MonteCarloRunner, RunConfig

DATA = os.path.join(os.path.dirname(__file__), "..", "artifacts", "data")

logging.basicConfig(format="%(name)s|%(message)s", level=logging.INFO)

t0 = time.time()
for i in range(1, 11):
    cfg = RunConfig(
        "bec", f"1200_3_6_rand_ldpc_{i}", "SPA",
        params=[0.31, 0.3], codeword=0, max_iter=10, min_wec=100,
        batch=8192, max_words=5_000_000, data_dir=DATA, seed=100 + i)
    res = MonteCarloRunner(cfg).run()
    print(f"member {i} done at {time.time() - t0:.0f}s: "
          + ", ".join(f"{p}: tot={v['tot']} wec={v['wec']} wer={v['wer']:.3g}"
                      for p, v in res.items()),
          flush=True)
print(f"ALL DONE in {time.time() - t0:.0f}s", flush=True)
