"""Multi-device / multi-host execution (the reference's 'distributed
backend' re-imagined: SURVEY.md 2.23 / section 5).

The reference parallelized at the shell: one POSIX process per
experiment, `&` + `wait`, JSON files on a shared filesystem as the
aggregation medium (run_sims.sh:15-25). Here parallelism lives inside
the program: codeword batches shard over a ``jax.sharding.Mesh`` axis,
error tallies combine with ``psum`` across devices, and multi-host runs
enter through :func:`initialize_distributed` with host 0 owning the
Saver.
"""

from ldpc_decoders_tpu.parallel.bp_edge_sharded import (  # noqa: F401
    EdgeShardedBPDecoder,
)
from ldpc_decoders_tpu.parallel.mesh import (  # noqa: F401
    batch_mesh,
    code_mesh,
    initialize_distributed,
    is_coordinator,
    local_batch,
)
