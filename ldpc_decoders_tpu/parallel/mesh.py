"""Mesh construction and multi-host initialization helpers.

Design (scaling-book recipe): pick a mesh, annotate shardings, let XLA
insert the collectives. For Monte-Carlo decoding the natural mesh is a
single ``batch`` axis spanning every device of every host — codeword
sims are embarrassingly parallel, so the only collectives are the
(tot, wec, bec) tally ``psum``s at the end of each super-batch chunk
(over NVLink within a host). Sweep points reuse
one compilation (the channel parameter is a traced scalar), so there is
no sweep axis to shard.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host entry: wire up jax.distributed. On single-host
    runs this is a no-op. (Replaces the reference's Slurm submitjob
    fan-out, README.md:89-93.)"""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def is_coordinator() -> bool:
    """True on the process that owns result files and console logs
    (the reference's cluster scripts let every Slurm task write its own
    JSON and merged later, run_sims.sh:15-25; here host 0 is the single
    writer and tallies are already globally psum-reduced)."""
    import jax

    return jax.process_index() == 0


def batch_mesh(n_devices: Optional[int] = None):
    """A 1-D ``batch`` mesh over (up to) all visible devices."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("batch",))


def code_mesh(n_code: int, n_batch: int = 0):
    """A mesh with a ``code`` axis (parity checks shard over it —
    EdgeShardedBPDecoder's model parallelism for codes too large for one
    chip) and optionally a ``batch`` axis for 2-D batch x code
    parallelism: Mesh [n_batch, n_code] with axes ("batch", "code")."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_batch and n_batch > 1:
        need = n_code * n_batch
        if len(devs) < need:
            raise ValueError(f"need {need} devices for a "
                             f"{n_batch}x{n_code} batch x code mesh")
        return Mesh(np.array(devs[:need]).reshape(n_batch, n_code),
                    ("batch", "code"))
    if len(devs) < n_code:
        raise ValueError(f"need {n_code} devices for a {n_code}-way "
                         f"code mesh, have {len(devs)}")
    return Mesh(np.array(devs[:n_code]), ("code",))


def local_batch(global_batch: int, mesh) -> int:
    """Per-device share of a global batch; validates divisibility."""
    n = mesh.devices.size
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide "
                         f"over {n} devices")
    return global_batch // n
