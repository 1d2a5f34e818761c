"""Ensemble BP: one compilation decoding G same-shape codes at once.

The reference sweeps code ensembles (10 random regular H samples) as 10
independent cluster jobs (simulations.py:79-85 REG_ENS). Decoding them
per-code recompiles per member. Same-shape ensemble
members differ only in their index tables, so stacking every table on a
leading axis and ``vmap``-ing the decode turns the whole ensemble into
ONE compiled program: [G, B, V] LLRs in, [G, B, V] decisions out —
SURVEY.md's "stack H edge-tables on a leading axis" parallelism row.

Uses the matmul permutation route (one-hot matrices stack naturally and
batch over G); memory is G * 2 * (~E^2) matrix entries, so
this is for short-to-medium ensemble codes (the reference's are n=1200,
E=3600: ~1 GB float32 at G=10).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ldpc_decoders_tpu.decoders.bp import (
    _INF_MIN,
    _NAN_MIN,
    INF_S,
    NAN_S,
    msa_check_rows,
    spa_check_rows,
    spa_check_rows_ref,
)
from ldpc_decoders_tpu.ops import perm as perm_ops
from ldpc_decoders_tpu.ops.graph import TannerGraph


class _EnsState(NamedTuple):
    v2c: jnp.ndarray
    x_hat: jnp.ndarray
    done: jnp.ndarray
    iters: jnp.ndarray
    it: jnp.ndarray


def check_member_shapes(graphs):
    """All member graphs must share (C, V, Dc, Dv) (edge counts may differ:
    irregular double-edge cancellation drops edges but not padded shapes)."""
    shapes = {(g.n_chk, g.n_var, g.max_chk_deg, g.max_var_deg)
              for g in graphs}
    if len(shapes) != 1:
        raise ValueError(f"ensemble members differ in shape: {shapes}")
    return next(iter(shapes))


def stack_member_tables(graphs, msg_dtype) -> dict:
    """One-hot permutation/mask tables for every member, stacked on a
    leading [G] axis so jax.vmap batches the member dimension."""
    return {
        "p_c2v": jnp.asarray(np.stack(
            [perm_ops.perm_chk_to_var(g) for g in graphs]), msg_dtype),
        "p_v2c": jnp.asarray(np.stack(
            [perm_ops.perm_var_to_chk(g) for g in graphs]), msg_dtype),
        "h_t": jnp.asarray(np.stack(
            [perm_ops.parity_matrix_t(g) for g in graphs])),
        "cmask": jnp.asarray(np.stack(
            [np.asarray(g.chk_mask) for g in graphs])),
        "vmask": jnp.asarray(np.stack(
            [np.asarray(g.var_mask) for g in graphs])),
    }


class EnsembleBPDecoder:
    """Batched SPA/MSA over a stacked code ensemble.

    decode(llr [G, B, V]) -> (x_hat [G, B, V] int32, iters [G, B]).
    All member graphs must share (C, V, Dc, Dv); one jit compilation
    serves every member (and any future same-shape resample).
    """

    id_keys = ["max_iter"]

    def __init__(self, graphs: Sequence[TannerGraph], variant: str = "SPA",
                 max_iter: int = 10, iter_cap: int = 1000,
                 msg_dtype=jnp.float32, check_init: bool = True,
                 inf_policy: str = "reference", **_):
        if variant not in ("SPA", "MSA"):
            raise ValueError(f"unknown BP variant {variant!r}")
        if inf_policy not in ("reference", "saturate"):
            raise ValueError(f"unknown inf_policy {inf_policy!r}")
        # Same semantics as BPDecoder.inf_policy: "reference" (SPA only)
        # reproduces the reference's float64 inf/NaN poison cascade the
        # golden SPA curves depend on (sentinel-encoded so it rides the
        # stacked one-hot matmuls); MSA has no saturation path.
        self.inf_policy = inf_policy if variant == "SPA" else "saturate"
        # check_init=False mirrors BPDecoder: biAWGN always runs >=1
        # iteration (reference bpa.py:19 initializes x_hat to real y).
        self.check_init = bool(check_init)
        (self.n_chk, self.n_var, self.max_chk_deg,
         self.max_var_deg) = check_member_shapes(graphs)
        self.n_members = len(graphs)
        self.variant = variant
        self.max_iter = int(max_iter)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        self.msg_dtype = jnp.dtype(msg_dtype)
        self._check_rows = (spa_check_rows if variant == "SPA"
                            else msa_check_rows)
        self.tables = stack_member_tables(graphs, self.msg_dtype)
        self._decode = jax.jit(jax.vmap(self._decode_one))

    @property
    def _dot_precision(self):
        # Same reduced-precision hazard as BPDecoder._dot_precision:
        # HIGHEST is IEEE float32 on the GPU, not TF32.
        return (lax.Precision.HIGHEST if self.msg_dtype == jnp.float32
                else lax.Precision.DEFAULT)

    # -- single-member decode, written over table ARGUMENTS so vmap can
    #    batch the member axis --------------------------------------------
    def _decode_one(self, tables: dict, llr: jnp.ndarray) -> tuple:
        C, V = self.n_chk, self.n_var
        Dc, Dv = self.max_chk_deg, self.max_var_deg
        dt = self.msg_dtype
        llr = llr.astype(jnp.float32)
        B = llr.shape[0]
        cmask, vmask = tables["cmask"], tables["vmask"]

        def chk_to_var(x):
            out = jnp.dot(x.reshape(B, C * Dc), tables["p_c2v"],
                          precision=self._dot_precision,
                          preferred_element_type=x.dtype)
            return out.reshape(B, V, Dv)

        def var_to_chk(x):
            out = jnp.dot(x.reshape(B, V * Dv), tables["p_v2c"],
                          precision=self._dot_precision,
                          preferred_element_type=x.dtype)
            return out.reshape(B, C, Dc)

        def syndrome_ok(x_hat):
            s = jnp.dot(x_hat.astype(jnp.float32), tables["h_t"],
                        preferred_element_type=jnp.float32)
            return (s.astype(jnp.int32) % 2 == 0).all(axis=-1)

        x0 = (llr < 0).astype(jnp.int32)
        pri = jnp.broadcast_to(llr[:, :, None], (B, V, Dv))
        state = _EnsState(
            v2c=var_to_chk(pri.astype(dt)),
            x_hat=x0,
            done=(syndrome_ok(x0) if self.check_init
                  else jnp.zeros(B, bool)),
            iters=jnp.zeros(B, jnp.int32),
            it=jnp.zeros((), jnp.int32),
        )

        def cond(s):
            return (s.it < self.iter_cap) & ~s.done.all()

        def _step_clean(v2c):
            c2v = self._check_rows(v2c, cmask)
            c2v_var = chk_to_var(c2v).astype(jnp.float32)
            marginal = llr + jnp.where(vmask, c2v_var, 0.0).sum(-1)
            v2c_var = (marginal[:, :, None] - c2v_var).astype(dt)
            return (marginal < 0).astype(jnp.int32), var_to_chk(v2c_var)

        def _step_ref(v2c):
            # Mirrors BPDecoder._spa_ref_step (bpa.py:31-62 float64
            # semantics, sentinel-encoded): saturated checks emit +-INF_S,
            # conflicting infinities at a variable -> NAN_S which decides
            # bit 0 and poisons edges via v2c = marginal - c2v computed
            # BEFORE the NaN zeroing. 3 stacked aggregation planes.
            f32 = jnp.float32
            c2v = spa_check_rows_ref(v2c, cmask).astype(f32)
            nan_i = c2v > _NAN_MIN
            pinf_i = (c2v > _INF_MIN) & ~nan_i
            ninf_i = c2v < -_INF_MIN
            fin_v = jnp.where(nan_i | pinf_i | ninf_i, 0.0, c2v)
            planes = jnp.stack(
                [fin_v, (pinf_i | nan_i).astype(f32),
                 (ninf_i | nan_i).astype(f32)], axis=1)  # [B, 3, C, Dc]
            agg = jnp.dot(planes.reshape(B * 3, C * Dc).astype(dt),
                          tables["p_c2v"],
                          precision=self._dot_precision,
                          preferred_element_type=f32)
            per_var = agg.reshape(B, 3, V, Dv)
            sums = jnp.where(vmask, per_var, 0.0).sum(-1)   # [B, 3, V]
            fin_sum, n_p, n_n = sums[:, 0], sums[:, 1], sums[:, 2]

            is_nan = (n_p > 0.5) & (n_n > 0.5)
            is_p = ~is_nan & (n_p > 0.5)
            is_n = ~is_nan & (n_n > 0.5)
            marg_fin = llr + fin_sum
            x_new = jnp.where(is_n, 1,
                              jnp.where(is_nan | is_p, 0,
                                        (marg_fin < 0).astype(jnp.int32)))
            marg_enc = jnp.where(
                is_nan, NAN_S,
                jnp.where(is_p, INF_S,
                          jnp.where(is_n, -INF_S, marg_fin)))
            edge_m = var_to_chk(
                jnp.where(vmask, marg_enc[:, :, None], 0.0).astype(dt)
            ).astype(f32)
            em_nan = edge_m > _NAN_MIN
            em_p = (edge_m > _INF_MIN) & ~em_nan
            em_n = edge_m < -_INF_MIN
            v2c_new = jnp.where(em_p, jnp.where(pinf_i, NAN_S, INF_S),
                                edge_m - fin_v)
            v2c_new = jnp.where(em_n, jnp.where(ninf_i, NAN_S, -INF_S),
                                v2c_new)
            v2c_new = jnp.where(em_nan, NAN_S, v2c_new)
            v2c_new = jnp.where(cmask, v2c_new, 0.0)
            return x_new.astype(jnp.int32), v2c_new.astype(dt)

        step = (_step_ref if (self.variant == "SPA"
                              and self.inf_policy == "reference")
                else _step_clean)

        def body(s):
            x_new, v2c_new = step(s.v2c)
            active = ~s.done
            x_hat = jnp.where(active[:, None], x_new, s.x_hat)
            v2c = jnp.where(active[:, None, None], v2c_new, s.v2c)
            return _EnsState(v2c, x_hat,
                             s.done | syndrome_ok(x_hat),
                             s.iters + active.astype(jnp.int32),
                             s.it + 1)

        final = lax.while_loop(cond, body, state)
        return final.x_hat, final.iters

    def decode(self, llr: jnp.ndarray, key=None) -> tuple:
        """llr [G, B, V] -> (x_hat [G, B, V], iters [G, B])."""
        if llr.shape[0] != self.n_members:
            raise ValueError(
                f"expected leading member axis {self.n_members}, "
                f"got {llr.shape}")
        return self._decode(self.tables, llr)

    def decode_tables(self, tables: dict, llr: jnp.ndarray) -> tuple:
        """Pure decode over *traced* tables, for callers that wrap this in
        their own jit (e.g. the ensemble harness chunk). Closing over
        ``self.tables`` there would bake gigabytes of stacked one-hot
        matrices into the program as literals — oversized HLO (the remote
        compile helper rejects it outright); passing them as arguments
        keeps the program small and the tables resident on device."""
        return jax.vmap(self._decode_one)(tables, llr)


class EnsembleBECSPADecoder:
    """Ternary-message erasure SPA over a stacked code ensemble.

    Same algorithm and termination semantics as
    :class:`~ldpc_decoders_tpu.decoders.bec_spa.BECSPADecoder` (reference
    src/bec.py:70-122: echo / single-unknown parity resolve / stopping-set
    exit), re-laid-out from per-edge [B, E] vectors into the padded check
    layout [B, C, Dc] so the member axis vmaps over stacked one-hot
    permutation matrices — edge counts may differ across members (padded
    shapes cannot), and the one compilation serves the whole ensemble.

    decode(y [G, B, V] symbols {0,1,2}) -> (x_hat [G, B, V], iters [G, B]).
    """

    id_keys = ["max_iter"]

    def __init__(self, graphs: Sequence[TannerGraph], max_iter: int = 10,
                 iter_cap: int = 1000, **_):
        (self.n_chk, self.n_var, self.max_chk_deg,
         self.max_var_deg) = check_member_shapes(graphs)
        self.n_members = len(graphs)
        self.max_iter = int(max_iter)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        self.tables = stack_member_tables(graphs, jnp.float32)
        self._decode = jax.jit(jax.vmap(self._decode_one))

    def _decode_one(self, tables: dict, y: jnp.ndarray) -> tuple:
        from ldpc_decoders_tpu.decoders.bec_spa import (
            _SIGN_TO_SYM,
            _SYM_TO_MSG,
            ERASURE,
        )

        C, V = self.n_chk, self.n_var
        Dc, Dv = self.max_chk_deg, self.max_var_deg
        B = y.shape[0]
        cmask, vmask = tables["cmask"], tables["vmask"]
        # DEFAULT precision (bf16 or TF32 operands) is EXACT here: every
        # message/marginal is a small integer (|x| <= Dv+1 << 256, exactly
        # representable in bfloat16) and the permutation matmuls select
        # one operand per output.
        prec = lax.Precision.DEFAULT

        def var_to_chk(x):      # [B, V, Dv] -> [B, C, Dc]; pads -> 0
            out = jnp.dot(x.reshape(B, V * Dv), tables["p_v2c"],
                          precision=prec, preferred_element_type=x.dtype)
            return out.reshape(B, C, Dc)

        def chk_to_var(x):      # [B, C, Dc] -> [B, V, Dv]; pads -> 0
            out = jnp.dot(x.reshape(B, C * Dc), tables["p_c2v"],
                          precision=prec, preferred_element_type=x.dtype)
            return out.reshape(B, V, Dv)

        priors = _SYM_TO_MSG[y]                                  # [B, V]
        pri_slots = jnp.where(vmask, priors[:, :, None], 0.0)    # [B, V, Dv]

        state = _EnsState(
            v2c=var_to_chk(pri_slots),
            x_hat=y.astype(jnp.int32),
            done=(y == ERASURE).sum(axis=-1) == 0,
            iters=jnp.zeros(B, jnp.int32),
            it=jnp.zeros((), jnp.int32),
        )

        def body(s):
            m = s.v2c                                        # pads are 0
            unknowns = ((m == 0.0) & cmask).sum(axis=-1)     # [B, C]
            ones = (m > 0.0).sum(axis=-1)
            parity_msg = (2.0 * (ones % 2) - 1.0)[..., None]
            known = jnp.abs(m)
            c2v_slots = jnp.where(
                unknowns[..., None] == 0, m,
                jnp.where(unknowns[..., None] == 1,
                          jnp.where(cmask, (1.0 - known) * parity_msg, 0.0),
                          0.0))
            c2v_var = chk_to_var(c2v_slots)                  # [B, V, Dv]
            marginal = priors + jnp.where(vmask, c2v_var, 0.0).sum(-1)
            v2c_var = jnp.where(
                vmask, jnp.sign(marginal[:, :, None] - c2v_var), 0.0)
            x_new = _SIGN_TO_SYM[jnp.sign(marginal).astype(jnp.int32) + 1]

            active = ~s.done
            stopped = active & (x_new == s.x_hat).all(axis=-1)
            x_hat = jnp.where(active[:, None], x_new, s.x_hat)
            v2c = jnp.where(active[:, None, None], var_to_chk(v2c_var),
                            s.v2c)
            iters = s.iters + active.astype(jnp.int32)
            decoded = (x_hat == ERASURE).sum(axis=-1) == 0
            return _EnsState(v2c, x_hat, s.done | decoded | stopped,
                             iters, s.it + 1)

        def cond(s):
            return (s.it < self.iter_cap) & ~s.done.all()

        final = lax.while_loop(cond, body, state)
        return final.x_hat, final.iters

    def decode(self, y: jnp.ndarray, key=None) -> tuple:
        """y [G, B, V] symbols -> (x_hat [G, B, V], iters [G, B])."""
        if y.shape[0] != self.n_members:
            raise ValueError(
                f"expected leading member axis {self.n_members}, "
                f"got {y.shape}")
        return self._decode(self.tables, y)

    def decode_tables(self, tables: dict, y: jnp.ndarray) -> tuple:
        """Pure decode over traced tables (see
        :meth:`EnsembleBPDecoder.decode_tables`)."""
        return jax.vmap(self._decode_one)(tables, y)
