"""Time the base-code REG campaign (the five def_cases sweeps on
LDPC(1200,3,6), reference simulations.py:27-39 `exc_def_cases`) through
the routes "auto" selects.

Usage: python scripts/regen_reg.py [--data_dir DIR] [--batch N]
Writes the Saver JSONs to --data_dir (default: a temp dir — pass
artifacts/data to refresh the committed artifacts) and prints one
timing line per sweep plus the total.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--batch", type=int, default=16384)
    args = ap.parse_args()

    from ldpc_decoders_tpu.campaign import def_cases
    from ldpc_decoders_tpu.harness import MonteCarloRunner

    data_dir = args.data_dir or tempfile.mkdtemp(prefix="reg_")
    t_all = time.time()
    for cfg in def_cases("1200_3_6_ldpc"):
        cfg = dataclasses.replace(
            cfg, data_dir=data_dir, batch=args.batch, log_freq=1e9,
            msg_dtype=("bfloat16" if cfg.channel == "biawgn"
                       else "float32"))
        t0 = time.time()
        MonteCarloRunner(cfg).run()
        print(f"{cfg.channel}-{cfg.decoder}: {time.time() - t0:.1f}s",
              flush=True)
    print(f"REG total: {time.time() - t_all:.1f}s  "
          f"-> {data_dir}")


if __name__ == "__main__":
    main()
