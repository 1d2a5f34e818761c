"""Regenerate the ensembles' cross-channel member curves: every
committed golden for the 10 regular and 10 irregular members on
BSC (SPA+MSA) and biAWGN (SPA+MSA), to complete member-level coverage
beyond the BEC SPA sets (reference simulations.py:79-85 ran each as an
independent cluster job; here each config rotates all 10 members
through one compiled chunk).

Configurations mirror the committed goldens:
  REG  members: max_iter=10  (bsc-1200_3_6_rand_ldpc_*-{MSA-10,SPA-10-0},
                biawgn-...-{MSA-10-1,SPA-10-0})
  IREG members: max_iter=100 (bsc-1200_rho_x5_rand_ldpc_*-{MSA-1-100,
                SPA-0-100}, biawgn likewise)
float32 messages throughout (the BSC tie structure is not bf16-safe;
docs/PARITY.md "Numerics").
"""
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
logging.basicConfig(format="%(asctime)s|%(name)s|%(message)s", level=logging.INFO)

from ldpc_decoders_tpu.harness import RunConfig
from ldpc_decoders_tpu.harness.runner import run_rotating_members

_BSC_MSA = [.081, .0751, .071, .0651, .061, .0551, .051, .0451, .041,
            .0351, .031, .0251, .021, .0151, .01]
_AWGN_MSA = [.5, .75, 1., 1.25, 1.5, 1.75, 2., 2.2, 2.3, 2.4, 2.5, 2.6,
             2.7, 2.8, 2.9, 3.0]
_AWGN_SPA = [.5, .75, 1., 1.25, 1.5, 1.75, 2., 2.25, 2.5, 2.75, 3.]
_BSC_SPA = [.1, .09, .08, .07, .06, .05, .04]

REG = [f"1200_3_6_rand_ldpc_{i}" for i in range(1, 11)]
IREG = [f"1200_rho_x5_rand_ldpc_{i}" for i in range(1, 11)]

CASES = [
    (REG, "bsc", "MSA", 1, 10, _BSC_MSA),
    (REG, "bsc", "SPA", 0, 10, _BSC_SPA),
    (REG, "biawgn", "MSA", 1, 10, _AWGN_MSA),
    (REG, "biawgn", "SPA", 0, 10, _AWGN_SPA),
    (IREG, "bsc", "MSA", 1, 100, _BSC_MSA),
    (IREG, "bsc", "SPA", 0, 100, _BSC_SPA),
    (IREG, "biawgn", "MSA", 1, 100, _AWGN_MSA),
    (IREG, "biawgn", "SPA", 0, 100, _AWGN_SPA),
]

data_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", "data")
t00 = time.time()
for members, channel, dec, cw, mi, params in CASES:
    t0 = time.time()
    cfg = RunConfig(channel, members[0], dec, params, codeword=cw,
                    max_iter=mi, min_wec=100, batch=4096, log_freq=30,
                    max_words=1_500_000, data_dir=data_dir)
    run_rotating_members(cfg, members)
    print("CASE %s %s %s done in %.1f s"
          % (members[0][:12], channel, dec, time.time() - t0), flush=True)
print("TOTAL WALL %.1f s" % (time.time() - t00), flush=True)
