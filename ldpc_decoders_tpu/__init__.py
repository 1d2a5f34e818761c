"""ldpc_decoders_tpu — a batched LDPC decoding and Monte-Carlo channel
simulation framework on JAX / XLA.

Capability-equivalent to the reference research codebase
``thadikari/ldpc_decoders`` (numpy/scipy, one codeword at a time on CPU),
re-designed for an accelerator:

- parity-check matrices compile to static edge-index gather tables
  (:mod:`ldpc_decoders_tpu.ops.graph`), so belief propagation runs as batched
  fixed-shape tensor programs over thousands of codewords at once;
- channel sampling, LLR initialisation, syndrome checks and early termination
  all run in-graph under ``jit`` with explicit ``jax.random`` keys;
- the ADMM decoder's parity-polytope Euclidean projection is a batched
  fixed-degree op (:mod:`ldpc_decoders_tpu.ops.projection`);
- multi-device scaling uses a ``jax.sharding.Mesh`` with codeword batches
  sharded over devices and error tallies combined with ``psum``
  (:mod:`ldpc_decoders_tpu.parallel`).

Reference parity map (file:line cites point into the reference repo):
see SURVEY.md at the repository root.
"""

import os

__version__ = "0.1.0"

# Persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset: one
# fixed directory inside the checkout (a moving path never hits, and the
# program writes nothing outside its checkout). Listed in .gitignore.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def _enable_persistent_compile_cache() -> None:
    """Point JAX at :data:`CACHE_DIR` unless the environment or an
    earlier ``jax.config`` update already chose a directory. JAX's
    writer is concurrency-safe (atomic temp + rename), so processes
    can share it."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
    except OSError:     # read-only checkout: run without a cache
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_persistent_compile_cache()

from ldpc_decoders_tpu.codes import Code, get_code, get_code_names  # noqa: F401
