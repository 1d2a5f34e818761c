"""Multi-host execution path (reference cluster contract, README.md:89-93:
one Slurm task per host, JSON merge on a shared filesystem).

Here the contract is: ``initialize_distributed`` wires jax.distributed,
every process runs the *same* MonteCarloRunner over the global mesh,
tallies psum-reduce to identical values everywhere, and host 0 is the
single Saver writer. The test spawns two real OS processes (CPU backend,
4 forced devices each -> one 8-device global mesh) and checks all of it.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from ldpc_decoders_tpu.harness import MonteCarloRunner, RunConfig

HERE = os.path.dirname(__file__)


@pytest.mark.slow
def test_two_process_distributed_sweep(tmp_path):
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    env = dict(os.environ)
    # Prepend (never replace) PYTHONPATH: keep whatever site setup the
    # parent runs with, and make the repository importable.
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] +
        ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "multihost_worker.py"),
         str(pid), "2", str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]

    results = [json.loads(line.split("RESULT ", 1)[1])
               for out in outs for line in out.splitlines()
               if line.startswith("RESULT ")]
    assert len(results) == 2
    r0 = next(r for r in results if r["pid"] == 0)
    r1 = next(r for r in results if r["pid"] == 1)
    # Globally psum-reduced tallies are identical on every host.
    assert (r0["tot"], r0["wec"], r0["bec"]) == \
        (r1["tot"], r1["wec"], r1["bec"])
    assert r0["wec"] >= 25
    # Host 0 owns the Saver; host 1 must not write.
    assert r0["coordinator"] and r0["saver"]
    assert not r1["coordinator"] and not r1["saver"]
    files = os.listdir(tmp_path)
    assert files == ["bsc-7_4_hamming-MSA-1-25-10.json"], files
    data = json.load(open(tmp_path / files[0]))
    assert data["wec"][str(0.1)] == r0["wec"]


def test_sharded_admm_histogram_matches_single_device(tmp_path):
    """The sharded path bins iteration counts in-graph (psum'd bincount —
    required under multi-process where per-device iters are not host-
    addressable). Same seed, same mesh-vs-single chunking: histograms and
    tallies must agree with the host-side bincount path."""
    devs = jax.devices()
    assert len(devs) >= 8, "conftest should provide 8 CPU devices"
    mesh = Mesh(np.array(devs[:8]), ("batch",))
    cfg = RunConfig(channel="bsc", code="7_4_hamming", decoder="ADMM",
                    params=[0.02], codeword=1, min_wec=5, batch=256,
                    max_iter=50, log_freq=1e9)
    res_m = MonteCarloRunner(cfg, mesh=mesh).run()[0.02]
    assert "dec" in res_m
    hist = np.array(res_m["dec"]["iter"])
    assert hist.sum() == res_m["tot"]
    assert res_m["dec"]["average"] > 0
    res_s = MonteCarloRunner(cfg).run()[0.02]
    # Distributional agreement (key layouts differ across chunkings).
    assert abs(res_m["dec"]["average"] - res_s["dec"]["average"]) < \
        0.5 * max(res_m["dec"]["average"], res_s["dec"]["average"])
