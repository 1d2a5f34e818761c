"""Batched ternary-message SPA for the binary erasure channel.

Functional batched re-design of the BEC-specific peeling BP in reference
src/bec.py:70-122 (a distinct algorithm from the LLR-domain bpa.py; the
reference aliases MSA = SPA for this channel, bec.py:125).

Symbol conventions preserved:
- channel symbols {0, 1, 2}: 2 means erasure (bec.py:15-18);
- messages {-1, +1, 0}: bit 0, bit 1, unknown (bec.py:74-75);
- termination: decoded (no erasures left), max_iter, or a *stopping set*
  (hard decisions unchanged between iterations, bec.py:120).

Check-node rule, exactly as the reference computes it (bec.py:98-112):
- a check with zero unknown incoming messages echoes each variable's own
  message (not extrinsic — harmless on a BEC where known messages are
  always correct);
- a check with exactly one unknown resolves that variable to the parity
  of the other incoming bits and sends 0 to everyone else;
- two or more unknowns: all outputs 0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ldpc_decoders_tpu.ops.graph import TannerGraph

ERASURE = 2
# y symbol {0,1,2} -> message {-1,+1,0}
_SYM_TO_MSG = jnp.array([-1.0, 1.0, 0.0])
# sign of marginal {-1,0,+1} (+1 offset) -> symbol {0,2,1}
_SIGN_TO_SYM = jnp.array([0, ERASURE, 1], dtype=jnp.int32)


class _State(NamedTuple):
    v2c: jnp.ndarray    # [B, E] messages in {-1, 0, +1}
    x_hat: jnp.ndarray  # [B, V] symbols in {0, 1, 2}
    done: jnp.ndarray   # [B] bool
    iters: jnp.ndarray  # [B] int32
    it: jnp.ndarray     # scalar int32


class BECSPADecoder:
    """Batched erasure-channel SPA. decode(y [B,V] in {0,1,2}) ->
    (x_hat [B,V] in {0,1,2}, iters [B])."""

    id_keys = ["max_iter"]

    def __init__(self, graph: TannerGraph, max_iter: int = 10,
                 iter_cap: int = 1000, **_):
        self.graph = graph
        self.max_iter = int(max_iter)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        self.tables = self.member_tables(graph)

    def member_tables(self, graph: TannerGraph,
                      n_edge_pad: int = 0) -> dict:
        """Member-specific index tables as traced-arg material.

        ``n_edge_pad`` >= n_edge pads the edge axis to a common length so
        ensemble members whose double-edge cancellation dropped different
        numbers of edges (irregular draws) still share one compiled
        program: padded "fake" edges are never referenced by any check
        row or variable column, so their message values are inert."""
        import numpy as np

        g = graph
        if (g.n_chk, g.n_var, g.max_chk_deg, g.max_var_deg) != (
                self.graph.n_chk, self.graph.n_var,
                self.graph.max_chk_deg, self.graph.max_var_deg):
            raise ValueError("member graph has different padded shapes")
        E, Ep = g.n_edge, max(int(n_edge_pad), g.n_edge)
        chk_edge = np.asarray(g.chk_edge)
        var_edge = np.asarray(g.var_edge)
        return {
            # Sentinel pad slots move from index E to the common Ep.
            "chk_edge": jnp.asarray(
                np.where(chk_edge == E, Ep, chk_edge)),
            "var_edge": jnp.asarray(
                np.where(var_edge == E, Ep, var_edge)),
            "edge_var": jnp.asarray(np.pad(np.asarray(g.edge_var),
                                           (0, Ep - E))),
            "edge_in_chk": jnp.asarray(np.pad(np.asarray(g.edge_in_chk),
                                              (0, Ep - E))),
        }

    def decode(self, y: jnp.ndarray, key=None) -> tuple:
        return self.decode_tables(self.tables, y, key)

    def decode_tables(self, t: dict, y: jnp.ndarray, key=None) -> tuple:
        """Pure decode over *traced* member tables (see
        :meth:`member_tables`). State rides the (possibly padded) edge
        axis ``Ep = t["edge_var"].shape[-1]``."""
        g = self.graph
        B = y.shape[0]

        def pad1(m, fill):
            return jnp.concatenate(
                [m, jnp.full(m.shape[:-1] + (1,), fill, m.dtype)], axis=-1)

        def gather_chk(m, fill):
            return jnp.take(pad1(m, fill), t["chk_edge"], axis=-1)

        def scatter_chk(vals):
            flat = vals.reshape(vals.shape[:-2]
                                + (g.n_chk * g.max_chk_deg,))
            return jnp.take(flat, t["edge_in_chk"], axis=-1)

        def sum_per_var(m):
            return jnp.take(pad1(m, 0.0), t["var_edge"], axis=-1).sum(-1)

        def expand_var(per_var):
            return jnp.take(per_var, t["edge_var"], axis=-1)

        priors = _SYM_TO_MSG[y]                      # [B, V]
        v2c0 = expand_var(priors)                    # [B, Ep]

        state = _State(
            v2c=v2c0,
            x_hat=y.astype(jnp.int32),
            done=(y == ERASURE).sum(axis=-1) == 0,
            iters=jnp.zeros(B, dtype=jnp.int32),
            it=jnp.zeros((), dtype=jnp.int32),
        )

        def body(s: _State):
            # Per-check layout. Pad fill -1: counts as a *known* message
            # that is not positive, so it is neutral both for the unknown
            # count and for the positive-parity count.
            m = gather_chk(s.v2c, fill=-1.0)         # [B, C, D]
            unknowns = (m == 0.0).sum(axis=-1)       # [B, C]
            ones = (m > 0.0).sum(axis=-1)            # [B, C]
            parity_msg = (2.0 * (ones % 2) - 1.0)[..., None]  # [B, C, 1]

            known = jnp.abs(m)  # 1 where known, 0 at the erased slot
            c2v_slots = jnp.where(
                unknowns[..., None] == 0, m,
                jnp.where(unknowns[..., None] == 1,
                          (1.0 - known) * parity_msg,
                          0.0))
            c2v = scatter_chk(c2v_slots)

            marginal = priors + sum_per_var(c2v)                 # [B, V]
            v2c_new = jnp.sign(expand_var(marginal) - c2v)       # [B, Ep]
            x_new = _SIGN_TO_SYM[jnp.sign(marginal).astype(jnp.int32) + 1]

            active = ~s.done
            stopped = active & (x_new == s.x_hat).all(axis=-1)  # stopping set
            x_hat = jnp.where(active[:, None], x_new, s.x_hat)
            v2c = jnp.where(active[:, None], v2c_new, s.v2c)
            iters = s.iters + active.astype(jnp.int32)
            decoded = (x_hat == ERASURE).sum(axis=-1) == 0
            done = s.done | decoded | stopped
            return _State(v2c, x_hat, done, iters, s.it + 1)

        def cond(s: _State):
            return (s.it < self.iter_cap) & ~s.done.all()

        final = lax.while_loop(cond, body, state)
        return final.x_hat, final.iters

    def decode_multi_cap(self, y: jnp.ndarray, caps, key=None) -> tuple:
        """One pass, hard decisions snapshotted at every iteration cap —
        same single-trajectory argument as
        :meth:`~ldpc_decoders_tpu.decoders.bp.BPDecoder.decode_multi_cap`
        (erasure peeling also freezes each word once decoded or caught in
        a stopping set). Returns (x_hats [K, B, V], iters [K, B])."""
        caps = tuple(int(c) for c in caps)
        assert list(caps) == sorted(caps) and caps[0] >= 1
        graph = self.graph
        B = y.shape[0]
        caps_arr = jnp.asarray(caps, jnp.int32)
        priors = _SYM_TO_MSG[y]
        x0 = y.astype(jnp.int32)
        snap0 = jnp.broadcast_to(x0[None], (len(caps),) + x0.shape)
        state = (_State(
            v2c=graph.expand_var(priors),
            x_hat=x0,
            done=(y == ERASURE).sum(axis=-1) == 0,
            iters=jnp.zeros(B, dtype=jnp.int32),
            it=jnp.zeros((), dtype=jnp.int32)), snap0)

        def body(ss):
            s, snap = ss
            m = graph.gather_chk(s.v2c, fill=-1.0)
            unknowns = (m == 0.0).sum(axis=-1)
            ones = (m > 0.0).sum(axis=-1)
            parity_msg = (2.0 * (ones % 2) - 1.0)[..., None]
            known = jnp.abs(m)
            c2v_slots = jnp.where(
                unknowns[..., None] == 0, m,
                jnp.where(unknowns[..., None] == 1,
                          (1.0 - known) * parity_msg,
                          0.0))
            c2v = graph.scatter_chk(c2v_slots)
            marginal = priors + graph.sum_per_var(c2v)
            v2c_new = jnp.sign(graph.expand_var(marginal) - c2v)
            x_new = _SIGN_TO_SYM[jnp.sign(marginal).astype(jnp.int32) + 1]

            active = ~s.done
            stopped = active & (x_new == s.x_hat).all(axis=-1)
            x_hat = jnp.where(active[:, None], x_new, s.x_hat)
            v2c = jnp.where(active[:, None], v2c_new, s.v2c)
            iters = s.iters + active.astype(jnp.int32)
            decoded = (x_hat == ERASURE).sum(axis=-1) == 0
            done = s.done | decoded | stopped
            hit = caps_arr == (s.it + 1)
            snap = jnp.where(hit[:, None, None], x_hat[None], snap)
            return _State(v2c, x_hat, done, iters, s.it + 1), snap

        def cond(ss):
            s, _ = ss
            return (s.it < caps[-1]) & ~s.done.all()

        final, snap = lax.while_loop(cond, body, state)
        snap = jnp.where((caps_arr > final.it)[:, None, None],
                         final.x_hat[None], snap)
        iters_k = jnp.minimum(final.iters[None], caps_arr[:, None])
        return snap, iters_k
