"""Worker process for the multi-host harness test.

Each worker is one "host" of a 2-process jax.distributed job (CPU
backend, 4 forced devices per process -> 8 global devices). It runs the
standard MonteCarloRunner sweep over the *global* mesh — the same code
path a real multi-host deployment uses (reference cluster contract:
README.md:89-93, one Slurm task per host) — and prints the tallies as a
JSON line for the parent test to compare across processes.

Usage: python multihost_worker.py <pid> <nproc> <port> <data_dir>
"""

import json
import os
import sys


def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    port, data_dir = sys.argv[3], sys.argv[4]

    # Env-var platform selection is overridden by site PJRT plugins here;
    # jax.config before backend init is the reliable switch, and
    # jax_num_cpu_devices (not XLA_FLAGS force_host_platform_device_count,
    # which can hang under the plugin) provides the virtual devices — see
    # tests/conftest.py note.
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)

    from ldpc_decoders_tpu.parallel import (batch_mesh,
                                            initialize_distributed,
                                            is_coordinator)
    initialize_distributed(f"localhost:{port}", nproc, pid)

    import jax
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 4 * nproc, jax.device_count()
    mesh = batch_mesh()
    assert mesh.devices.size == 4 * nproc

    from ldpc_decoders_tpu.harness import MonteCarloRunner, RunConfig
    cfg = RunConfig(channel="bsc", code="7_4_hamming", decoder="MSA",
                    params=[0.1], codeword=1, min_wec=25,
                    batch=8 * nproc, max_words=4000, log_freq=1e9,
                    data_dir=data_dir)
    runner = MonteCarloRunner(cfg, mesh=mesh)
    res = runner.run()[0.1]

    print("RESULT " + json.dumps({
        "pid": pid,
        "coordinator": is_coordinator(),
        "tot": res["tot"], "wec": res["wec"], "bec": res["bec"],
        "saver": runner.saver is not None,
    }), flush=True)


if __name__ == "__main__":
    main()
