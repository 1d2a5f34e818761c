"""Static edge-table representation of a Tanner graph.

The reference decodes one codeword at a time through dynamic
``scipy.sparse`` matrices (reference src/bpa.py:12 builds ``np.where(H)``
per decoder instance and re-materialises COO/CSR objects every iteration).
Here H compiles once into fixed int32 index tables; message
passing becomes gather → fixed-width reduction → gather, with no scatter
and no dynamic shapes, so XLA can fuse and tile everything.

Layout
------
Edges are numbered in CSR order (sorted by check row, then variable column).
For every message vector ``m`` of shape ``[..., E]``:

- ``gather_chk(m)`` produces ``[..., C, Dc]`` (padded to the max check
  degree with a fill value) — one row per check node;
- ``gather_var(m)`` produces ``[..., V, Dv]`` — one row per variable node;
- ``scatter_chk(x)`` / ``scatter_var(x)`` invert the gathers: each edge
  appears in exactly one (node, slot) position, so the inverse is itself a
  gather through a precomputed flat index — no scatter-add needed.

Padding uses a sentinel edge index ``E`` pointing at a virtual extra slot
whose value is the ``fill`` argument.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
from jax import lax


@dataclasses.dataclass(frozen=True)
class TannerGraph:
    """Compiled, immutable edge tables for one parity-check matrix."""

    n_chk: int
    n_var: int
    n_edge: int
    # [E] int32: check / variable index of each edge (CSR order).
    edge_chk: jnp.ndarray
    edge_var: jnp.ndarray
    # [C, Dc] int32 edge ids per check, padded with n_edge; + bool mask.
    chk_edge: jnp.ndarray
    chk_mask: jnp.ndarray
    # [V, Dv] int32 edge ids per variable, padded with n_edge; + bool mask.
    var_edge: jnp.ndarray
    var_mask: jnp.ndarray
    # Degrees.
    chk_deg: jnp.ndarray  # [C] int32
    var_deg: jnp.ndarray  # [V] int32
    max_chk_deg: int
    max_var_deg: int
    # Flat inverse indices: edge -> position in the chk/var gather layout.
    edge_in_chk: jnp.ndarray  # [E] int32 into flattened [C*Dc]
    edge_in_var: jnp.ndarray  # [E] int32 into flattened [V*Dv]
    # Direct slot-to-slot permutations between the two padded layouts
    # (composition of scatter+gather, precomputed so one gather converts
    # layouts — the BP hot path needs only two of these per iteration).
    # Sentinel: index C*Dc (resp. V*Dv) selects the appended fill slot.
    var_slot_from_chk: jnp.ndarray  # [V*Dv] int32 into flat [C*Dc]+fill
    chk_slot_from_var: jnp.ndarray  # [C*Dc] int32 into flat [V*Dv]+fill
    # Distinct check degrees (python ints, static) for degree-bucketed ops.
    chk_degrees: tuple

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_parity_mtx(parity_mtx: np.ndarray) -> "TannerGraph":
        """Compile a dense 0/1 parity-check matrix H of shape [C, V]."""
        H = np.asarray(parity_mtx)
        n_chk, n_var = H.shape
        rows, cols = np.nonzero(H)
        # CSR order: np.nonzero already returns row-major order.
        E = rows.size

        def build_side(node_of_edge: np.ndarray, n_nodes: int):
            deg = np.bincount(node_of_edge, minlength=n_nodes).astype(np.int32)
            dmax = int(deg.max()) if E else 1
            table = np.full((n_nodes, dmax), E, dtype=np.int32)
            slot = np.zeros(n_nodes, dtype=np.int32)
            inv = np.zeros(E, dtype=np.int32)
            for e, node in enumerate(node_of_edge):
                s = slot[node]
                table[node, s] = e
                inv[e] = node * dmax + s
                slot[node] = s + 1
            mask = table != E
            return deg, dmax, table, mask, inv

        chk_deg, dc, chk_edge, chk_mask, edge_in_chk = build_side(rows, n_chk)
        var_deg, dv, var_edge, var_mask, edge_in_var = build_side(cols, n_var)

        # Layout-to-layout permutations: invert one side's edge->slot map,
        # compose with the other's. Pad slots point at the sentinel.
        def compose(inv_a: np.ndarray, slots_a: int, edge_in_b: np.ndarray,
                    sentinel_b: int) -> np.ndarray:
            slot_to_edge = np.full(slots_a, E, dtype=np.int64)
            slot_to_edge[inv_a] = np.arange(E)
            out = np.full(slots_a, sentinel_b, dtype=np.int32)
            real = slot_to_edge < E
            out[real] = edge_in_b[slot_to_edge[real]]
            return out

        var_slot_from_chk = compose(edge_in_var, n_var * dv, edge_in_chk,
                                    n_chk * dc)
        chk_slot_from_var = compose(edge_in_chk, n_chk * dc, edge_in_var,
                                    n_var * dv)

        return TannerGraph(
            n_chk=n_chk,
            n_var=n_var,
            n_edge=E,
            edge_chk=jnp.asarray(rows, dtype=jnp.int32),
            edge_var=jnp.asarray(cols, dtype=jnp.int32),
            chk_edge=jnp.asarray(chk_edge),
            chk_mask=jnp.asarray(chk_mask),
            var_edge=jnp.asarray(var_edge),
            var_mask=jnp.asarray(var_mask),
            chk_deg=jnp.asarray(chk_deg),
            var_deg=jnp.asarray(var_deg),
            max_chk_deg=dc,
            max_var_deg=dv,
            edge_in_chk=jnp.asarray(edge_in_chk),
            edge_in_var=jnp.asarray(edge_in_var),
            var_slot_from_chk=jnp.asarray(var_slot_from_chk),
            chk_slot_from_var=jnp.asarray(chk_slot_from_var),
            chk_degrees=tuple(sorted(set(int(d) for d in chk_deg))),
        )

    # ------------------------------------------------------------------
    # Gather / scatter between edge vectors and node layouts
    # ------------------------------------------------------------------
    def _pad_edges(self, msgs: jnp.ndarray, fill) -> jnp.ndarray:
        """Append the virtual fill slot so sentinel index E is valid."""
        pad_shape = msgs.shape[:-1] + (1,)
        pad = jnp.full(pad_shape, fill, dtype=msgs.dtype)
        return jnp.concatenate([msgs, pad], axis=-1)

    def gather_chk(self, msgs: jnp.ndarray, fill=0.0) -> jnp.ndarray:
        """[..., E] -> [..., C, Dc]; padded slots get `fill`."""
        padded = self._pad_edges(msgs, fill)
        return jnp.take(padded, self.chk_edge, axis=-1)

    def gather_var(self, msgs: jnp.ndarray, fill=0.0) -> jnp.ndarray:
        """[..., E] -> [..., V, Dv]; padded slots get `fill`."""
        padded = self._pad_edges(msgs, fill)
        return jnp.take(padded, self.var_edge, axis=-1)

    def scatter_chk(self, vals: jnp.ndarray) -> jnp.ndarray:
        """[..., C, Dc] -> [..., E] (inverse of gather_chk)."""
        flat = vals.reshape(vals.shape[:-2] + (self.n_chk * self.max_chk_deg,))
        return jnp.take(flat, self.edge_in_chk, axis=-1)

    def scatter_var(self, vals: jnp.ndarray) -> jnp.ndarray:
        """[..., V, Dv] -> [..., E] (inverse of gather_var)."""
        flat = vals.reshape(vals.shape[:-2] + (self.n_var * self.max_var_deg,))
        return jnp.take(flat, self.edge_in_var, axis=-1)

    # ------------------------------------------------------------------
    # Direct layout-to-layout conversion (single gather each way).
    # The BP hot loop keeps messages in the [C, Dc] check layout and pays
    # exactly two of these permutations per iteration, instead of four
    # edge-vector gathers (scatter_chk + gather_var + expand_var + ...).
    # ------------------------------------------------------------------
    def chk_to_var(self, chk_vals: jnp.ndarray, fill) -> jnp.ndarray:
        """[..., C, Dc] -> [..., V, Dv]; var pad slots get `fill`."""
        lead = chk_vals.shape[:-2]
        flat = chk_vals.reshape(lead + (self.n_chk * self.max_chk_deg,))
        pad = jnp.full(lead + (1,), fill, dtype=chk_vals.dtype)
        flat = jnp.concatenate([flat, pad], axis=-1)
        out = jnp.take(flat, self.var_slot_from_chk, axis=-1)
        return out.reshape(lead + (self.n_var, self.max_var_deg))

    def var_to_chk(self, var_vals: jnp.ndarray, fill) -> jnp.ndarray:
        """[..., V, Dv] -> [..., C, Dc]; chk pad slots get `fill`."""
        lead = var_vals.shape[:-2]
        flat = var_vals.reshape(lead + (self.n_var * self.max_var_deg,))
        pad = jnp.full(lead + (1,), fill, dtype=var_vals.dtype)
        flat = jnp.concatenate([flat, pad], axis=-1)
        out = jnp.take(flat, self.chk_slot_from_var, axis=-1)
        return out.reshape(lead + (self.n_chk, self.max_chk_deg))

    # ------------------------------------------------------------------
    # Common reductions
    # ------------------------------------------------------------------
    def sum_per_var(self, msgs: jnp.ndarray) -> jnp.ndarray:
        """Column sums: [..., E] -> [..., V]. (reference math_utils.py:7)"""
        return self.gather_var(msgs, fill=0.0).sum(axis=-1)

    def sum_per_chk(self, msgs: jnp.ndarray) -> jnp.ndarray:
        """Row sums: [..., E] -> [..., C]."""
        return self.gather_chk(msgs, fill=0.0).sum(axis=-1)

    def expand_var(self, per_var: jnp.ndarray) -> jnp.ndarray:
        """[..., V] -> [..., E]: value of an edge's variable node."""
        return jnp.take(per_var, self.edge_var, axis=-1)

    def expand_chk(self, per_chk: jnp.ndarray) -> jnp.ndarray:
        """[..., C] -> [..., E]: value of an edge's check node."""
        return jnp.take(per_chk, self.edge_chk, axis=-1)

    def syndrome_ok(self, x_hat: jnp.ndarray) -> jnp.ndarray:
        """All-checks-satisfied indicator. [..., V] bits -> [...] bool.

        Equivalent to the reference's ``((H @ x_hat) % 2 == 0).all()``
        (reference src/bpa.py:29) but batched and without matmul: per-check
        XOR via a masked gather + sum mod 2.
        """
        bits = jnp.take(x_hat.astype(jnp.int32), self.edge_var, axis=-1)
        per_chk = self.gather_chk(bits, fill=0)
        return (per_chk.sum(axis=-1) % 2 == 0).all(axis=-1)

    def checks_of_degree(self, d: int) -> np.ndarray:
        """Static (host) index array of checks whose degree == d."""
        return np.nonzero(np.asarray(self.chk_deg) == d)[0].astype(np.int32)


# ----------------------------------------------------------------------
# Exclusive (leave-one-out) reductions along the last (slot) axis.
# These replace the reference's "total product divided by self" trick
# (reference src/bpa.py:73-74), which is division-by-zero prone; the
# prefix/suffix form is exact and branch-free. Dc is small (<= ~10), so the
# O(D) cumulative ops are trivially cheap and fuse into the gather.
# ----------------------------------------------------------------------

def exclusive_sum(x: jnp.ndarray) -> jnp.ndarray:
    """Leave-one-out sum along the last axis via prefix/suffix partial sums.

    Exact (no ``total - self`` catastrophic cancellation when one term
    dominates, which matters for phi-domain SPA messages).
    """
    d = x.shape[-1]
    if d == 1:
        return jnp.zeros_like(x)
    zero = jnp.zeros(x.shape[:-1] + (1,), dtype=x.dtype)
    prefix = jnp.concatenate(
        [zero, jnp.cumsum(x, axis=-1)[..., :-1]], axis=-1)
    suffix = jnp.concatenate(
        [jnp.cumsum(x[..., ::-1], axis=-1)[..., ::-1][..., 1:], zero],
        axis=-1)
    return prefix + suffix


def exclusive_min(x: jnp.ndarray) -> jnp.ndarray:
    """Leave-one-out min along the last axis via prefix/suffix mins."""
    d = x.shape[-1]
    if d == 1:
        return jnp.full_like(x, jnp.inf)
    inf = jnp.full(x.shape[:-1] + (1,), jnp.inf, dtype=x.dtype)
    prefix = jnp.concatenate(
        [inf, lax.cummin(x, axis=x.ndim - 1)[..., :-1]], axis=-1)
    suffix = jnp.concatenate(
        [lax.cummin(x[..., ::-1], axis=x.ndim - 1)[..., ::-1][..., 1:], inf],
        axis=-1)
    return jnp.minimum(prefix, suffix)


def exclusive_sign_parity(neg: jnp.ndarray) -> jnp.ndarray:
    """Leave-one-out sign product from a 0/1 negativity mask, as
    negative-count parity (integer adds): equivalent to a float +-1
    product reduction for real inputs, and cheaper. Returns int +-1."""
    excl = neg.sum(axis=-1, keepdims=True) - neg  # exact: integer counts
    return 1 - 2 * (excl % 2)


def exclusive_prod_sign(sign: jnp.ndarray) -> jnp.ndarray:
    """Leave-one-out product of +-1 signs along the last axis."""
    neg = (sign < 0).astype(jnp.int32)
    return exclusive_sign_parity(neg).astype(sign.dtype)
