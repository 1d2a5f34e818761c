"""Small host-side math helpers (reference src/math_utils.py equivalents).

The sparse-matrix reductions of the reference (sum_axis, prod_nonzero,
csr_csc_argmax — math_utils.py:7-94) have no counterpart here: on the
device those become the fixed-shape gather reductions in
:mod:`ldpc_decoders_tpu.ops.graph`. What remains are the genuinely
host-side helpers.
"""

from __future__ import annotations

import numpy as np


def binary_vectors(length: int) -> np.ndarray:
    """All 2^length binary vectors, row i = big-endian bits of i.

    Ordering matches the reference (math_utils.py:19-25, itertools.product
    over "01"): row index counts up with the FIRST column as the most
    significant bit, and row 0 is all zeros.
    """
    idx = np.arange(2 ** length, dtype=np.int64)
    shifts = np.arange(length - 1, -1, -1, dtype=np.int64)
    return ((idx[:, None] >> shifts) & 1).astype(np.int64)


def pseudo_to_cw(x: np.ndarray, allow_pseudo: bool, eps: float = 1e-8) -> np.ndarray:
    """Snap a fractional LP/ADMM solution to {0,1} only where it is within
    eps of integral (allow_pseudo=True keeps interior pseudo-codeword
    coordinates fractional); otherwise threshold at 0.5.
    (reference math_utils.py:28-34)
    """
    x = np.array(x, dtype=np.float64)
    if allow_pseudo:
        x[x < eps] = 0.0
        x[1.0 - x < eps] = 1.0
        return x
    return (x > 0.5).astype(np.int64)


def pseudo_to_cw_jnp(x, allow_pseudo: bool, eps: float = 1e-8):
    """jit-compatible twin of :func:`pseudo_to_cw`, shared by the ADMM
    and ADMMA decoders (reference math_utils.py:28-34)."""
    import jax.numpy as jnp

    if not allow_pseudo:
        return (x > 0.5).astype(jnp.int32)
    x = jnp.where(x < eps, 0.0, x)
    return jnp.where(1.0 - x < eps, 1.0, x)


def arg_max_rand(values: np.ndarray, rng: np.random.Generator) -> int:
    """Argmax with uniform random tie-breaking (reference math_utils.py:72-74)."""
    values = np.asarray(values)
    maxima = np.flatnonzero(values == values.max())
    return int(rng.choice(maxima))
