"""One-hot matrices that turn Tanner-graph data movement into matmuls,
and the decoders' choice between those and index gathers.

Layout permutations, per-node aggregations and the syndrome check are all
sparse 0/1 linear maps over the padded layouts; materializing them as
dense one-hot matrices turns each hop into a matmul with bit-identical
results (each output row has exactly one, or per-node degree-many, unit
coefficients). A gather moves O(E) values per hop where the one-hot
product does O(E * V) multiply-adds, so the choice is a measured one
(:func:`auto_bp_perm`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Largest padded-slot count (n_chk*max_chk_deg / n_var*max_var_deg — what
# actually sizes the matrices; for irregular codes the padded layout is
# 2-3x n_edge) for which the incidence tables [C*Dc, V] are built at all:
# margulis needs 2 x 84 MB in float32.
INCIDENCE_MAX_SLOTS = 16384


def padded_slots(graph) -> int:
    return max(graph.n_chk * graph.max_chk_deg,
               graph.n_var * graph.max_var_deg)


def auto_bp_perm(graph, msg_dtype) -> str:
    """The BP data-movement route ``perm="auto"`` selects, from the H100
    route timings at batch 16384 (PERF.md "Bring-up on the H100"):

    - bfloat16 messages: "incidence". The one-hot [E, V] dots run on the
      tensor cores and beat the gathers 2.3x (refmode SPA) to 7.0x (MSA)
      at LDPC(1200,3,6), 1.4x to 3.5x at margulis;
    - float32 messages: "gather". The dots run at Precision.HIGHEST on
      IEEE float32 units, which ties the gathers for MSA and loses 2.3x
      for refmode SPA.

    Codes past ``INCIDENCE_MAX_SLOTS`` gather in either dtype."""
    if (jnp.dtype(msg_dtype) == jnp.bfloat16
            and padded_slots(graph) <= INCIDENCE_MAX_SLOTS):
        return "incidence"
    return "gather"


def perm_chk_to_var(graph) -> np.ndarray:
    """[C*Dc, V*Dv] one-hot: chk-layout flat -> var-layout flat."""
    nc = graph.n_chk * graph.max_chk_deg
    nv = graph.n_var * graph.max_var_deg
    vfc = np.asarray(graph.var_slot_from_chk)
    P = np.zeros((nc, nv), np.float32)
    real = vfc < nc
    P[vfc[real], np.nonzero(real)[0]] = 1.0
    return P


def perm_var_to_chk(graph) -> np.ndarray:
    """[V*Dv, C*Dc] one-hot: var-layout flat -> chk-layout flat."""
    nc = graph.n_chk * graph.max_chk_deg
    nv = graph.n_var * graph.max_var_deg
    cfv = np.asarray(graph.chk_slot_from_var)
    P = np.zeros((nv, nc), np.float32)
    real = cfv < nv
    P[cfv[real], np.nonzero(real)[0]] = 1.0
    return P


def var_sum_matrix(graph) -> np.ndarray:
    """[C*Dc, V]: sums chk-layout edge values per variable (pads drop)."""
    nc = graph.n_chk * graph.max_chk_deg
    S = np.zeros((nc, graph.n_var), np.float32)
    S[np.asarray(graph.edge_in_chk), np.asarray(graph.edge_var)] = 1.0
    return S


def var_broadcast_matrix(graph) -> np.ndarray:
    """[V, C*Dc]: broadcasts a per-variable value onto its chk-layout
    edge slots (transpose of var_sum_matrix)."""
    return var_sum_matrix(graph).T.copy()


def parity_matrix_t(graph) -> np.ndarray:
    """[V, C] dense H^T for the matmul syndrome check."""
    H = np.zeros((graph.n_chk, graph.n_var), np.float32)
    H[np.asarray(graph.edge_chk), np.asarray(graph.edge_var)] = 1.0
    return H.T.copy()
