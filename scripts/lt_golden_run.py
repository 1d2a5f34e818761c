"""Driver for the golden-scale LT artifacts (k=10000/n=12000, all three
reference operating points c in {0.01, 0.03, 0.1}).

CPU backend forced via jax.config. ``count`` is a TOTAL target —
lt.main resumes from a committed artifact, so re-running extends toward
the reference's 2750-sim scale.

Run:  python scripts/lt_golden_run.py [c ...]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

from ldpc_decoders_tpu.fountain import lt

TARGETS = {"0.01": 2750, "0.03": 2750, "0.1": 2750}

if __name__ == "__main__":
    cs = sys.argv[1:] or list(TARGETS)
    data_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "data")
    for c in cs:
        lt.main(["10000", "12000", c, "0.5", str(TARGETS[c]),
                 "--data_dir", data_dir, "--seed", "11", "--batch", "8"])
