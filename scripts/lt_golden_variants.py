"""Golden-scale LT artifacts for the remaining committed soliton
parameters (reference data/output/luby-10000-12000-{0.03,0.1}-0.5.json,
2750 sims each; we match the statistic with 500 sims per point).
CPU backend forced via jax.config."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

from ldpc_decoders_tpu.fountain import lt

if __name__ == "__main__":
    c = sys.argv[1]
    lt.main(["10000", "12000", c, "0.5", "500",
             "--data_dir", "artifacts/data", "--seed", "11", "--batch", "50"])
