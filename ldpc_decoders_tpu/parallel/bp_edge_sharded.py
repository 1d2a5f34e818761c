"""Edge-sharded BP: model-parallel decoding for codes too large for one
chip (SURVEY.md section 5 "long-code edge sharding").

The data-parallel harness shards the CODEWORD axis; here the CODE itself
shards: each device owns a contiguous slice of parity checks (and hence
of edges / messages), LLRs and marginals stay replicated, and each BP
iteration makes ONE collective — a psum of the per-device partial
check-to-variable sums [B, V] over the ``code`` mesh axis (the classic
tensor-parallel activation all-reduce, over NVLink). Message memory per
device is E/n_devices — a billion-edge code fits a multi-device mesh at the same
per-iteration math as the single-chip decoder.

Check updates reuse the exact SPA/MSA row kernels of
:mod:`~ldpc_decoders_tpu.decoders.bp`; semantics (syndrome-before-
iteration early exit, per-word freeze, iteration counts, max_iter<=0
cap) match BPDecoder — see the agreement test. Per-slice tables ride the
call as shard_map arguments sharded on their leading device axis (big
constants baked into the program would blow the compile-request limit).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from ldpc_decoders_tpu.decoders.bp import (
    INF_S,
    NAN_S,
    _INF_MIN,
    _NAN_MIN,
    msa_check_rows,
    spa_check_rows,
    spa_check_rows_ref,
)


class _ShardTables(NamedTuple):
    """Per-device slice tables, stacked on a leading [n_dev] axis."""
    var_of_slot: jnp.ndarray   # [n_dev, C_loc * Dc] int32; pads -> V
    mask: jnp.ndarray          # [n_dev, C_loc, Dc] bool


def build_shard_tables(parity_mtx: np.ndarray, n_dev: int) -> _ShardTables:
    H = np.asarray(parity_mtx)
    C, V = H.shape
    dc = int(H.sum(axis=1).max())
    c_loc = math.ceil(C / n_dev)
    var_of_slot = np.full((n_dev, c_loc * dc), V, dtype=np.int32)
    mask = np.zeros((n_dev, c_loc, dc), dtype=bool)
    for d in range(n_dev):
        rows = range(d * c_loc, min((d + 1) * c_loc, C))
        for i, r in enumerate(rows):
            cols = np.nonzero(H[r])[0]
            var_of_slot[d, i * dc:i * dc + cols.size] = cols
            mask[d, i, :cols.size] = True
    return _ShardTables(jnp.asarray(var_of_slot), jnp.asarray(mask))


class EdgeShardedBPDecoder:
    """SPA/MSA with parity checks sharded over a mesh axis.

    decode(llr [B, V]) -> (x_hat [B, V] int32, iters [B] int32),
    replicated on every device of the mesh.
    """

    id_keys = ["max_iter"]

    def __init__(self, parity_mtx: np.ndarray, mesh, variant: str = "SPA",
                 max_iter: int = 10, iter_cap: int = 1000,
                 axis: str = "code", batch_axis: str = None,
                 check_init: bool = True, inf_policy: str = "reference",
                 **_):
        if variant not in ("SPA", "MSA"):
            raise ValueError(f"unknown BP variant {variant!r}")
        if inf_policy not in ("reference", "saturate"):
            raise ValueError(f"unknown inf_policy {inf_policy!r}")
        H = np.asarray(parity_mtx)
        self.n_var = int(H.shape[1])
        self.mesh = mesh
        self.axis = axis
        self.check_init = bool(check_init)
        self.max_iter = int(max_iter)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        # Same default as BPDecoder: SPA reproduces the reference's
        # float64 inf/NaN cascade (sentinel-encoded; load-bearing for
        # the golden SPA curves — decoders/bp.py). The class planes
        # aggregate with the SAME one psum per iteration, just stacked:
        # [B, 3, V] instead of [B, V].
        self.inf_policy = inf_policy if variant == "SPA" else "saturate"
        self._check_rows = (spa_check_rows if variant == "SPA"
                            else msa_check_rows)
        n_dev = int(np.prod([mesh.shape[a] for a in (axis,)]))
        self.tables = build_shard_tables(H, n_dev)
        # Optional 2-D parallelism: with ``batch_axis`` the codeword
        # batch shards over a second mesh axis while checks shard over
        # ``axis`` — the per-iteration psum stays over ``axis`` only, so
        # each batch shard decodes its rows against the full code.
        bspec = P(batch_axis) if batch_axis else P()
        self._decode = jax.jit(jax.shard_map(
            self._device_decode, mesh=mesh,
            in_specs=(P(axis), bspec, bspec),
            out_specs=(bspec, bspec),
            check_vma=False))

    # -- per-device program ---------------------------------------------
    def _device_decode(self, tables: _ShardTables, llr, x0):
        ax = self.axis
        V = self.n_var
        var_of_slot = tables.var_of_slot[0]          # local [C_loc * Dc]
        mask = tables.mask[0]                        # local [C_loc, Dc]
        c_loc, dc = mask.shape
        B = llr.shape[0]

        def pad_var(x):                              # [B, V] -> [B, V+1]
            return jnp.concatenate(
                [x, jnp.zeros((B, 1), x.dtype)], axis=1)

        def to_slots(per_var):                       # [B, V] -> [B, C_loc, Dc]
            return pad_var(per_var)[:, var_of_slot].reshape(B, c_loc, dc)

        def sum_per_var(slots):                      # [B, C_loc, Dc] -> [B, V]
            flat = jnp.where(mask.reshape(-1), slots.reshape(B, -1), 0.0)
            partial = jnp.zeros((B, V + 1), flat.dtype).at[
                :, var_of_slot].add(flat)[:, :V]
            return lax.psum(partial, ax)

        def sum_planes_per_var(planes):  # [B, P, C_loc, Dc] -> [B, P, V]
            P_ = planes.shape[1]
            flat = jnp.where(mask.reshape(-1), planes.reshape(B, P_, -1),
                             0.0)
            partial = jnp.zeros((B, P_, V + 1), flat.dtype).at[
                :, :, var_of_slot].add(flat)[:, :, :V]
            return lax.psum(partial, ax)     # still ONE psum / iteration

        def syndrome_ok(x_hat):                      # [B, V] -> [B] (global)
            bits = to_slots(x_hat.astype(jnp.float32))
            odd = jnp.where(mask, bits, 0.0).sum(-1).astype(jnp.int32) % 2
            return lax.psum(odd.sum(-1), ax) == 0

        done0 = (syndrome_ok(x0) if self.check_init
                 else jnp.zeros(B, bool))
        v2c0 = jnp.where(mask, to_slots(llr), 0.0)

        class S(NamedTuple):
            v2c: jnp.ndarray
            x_hat: jnp.ndarray
            done: jnp.ndarray
            all_done: jnp.ndarray
            iters: jnp.ndarray
            it: jnp.ndarray

        def cond(s):
            return (s.it < self.iter_cap) & ~s.all_done

        def ref_step(v2c):
            """One refmode SPA iteration, sharded: the sentinel-class
            logic of BPDecoder._spa_ref_step (bpa.py:31-62 float64
            semantics) with the 3 aggregation planes (finite sum, +inf/
            NaN count, -inf/NaN count) riding the single per-iteration
            psum stacked on a P axis."""
            c2v = spa_check_rows_ref(v2c, mask)      # local rows
            nan_i = c2v > _NAN_MIN
            pinf_i = (c2v > _INF_MIN) & ~nan_i
            ninf_i = c2v < -_INF_MIN
            fin_v = jnp.where(nan_i | pinf_i | ninf_i, 0.0, c2v)
            planes = jnp.stack(
                [fin_v, (pinf_i | nan_i).astype(jnp.float32),
                 (ninf_i | nan_i).astype(jnp.float32)], axis=1)
            sums = sum_planes_per_var(planes)        # [B, 3, V]
            fin_sum, n_p, n_n = sums[:, 0], sums[:, 1], sums[:, 2]

            is_nan = (n_p > 0.5) & (n_n > 0.5)
            is_p = ~is_nan & (n_p > 0.5)
            is_n = ~is_nan & (n_n > 0.5)
            marg_fin = llr + fin_sum
            x_new = jnp.where(is_n, 1,
                              jnp.where(is_nan | is_p, 0,
                                        (marg_fin < 0).astype(jnp.int32)))
            marg_enc = jnp.where(is_nan, NAN_S,
                                 jnp.where(is_p, INF_S,
                                           jnp.where(is_n, -INF_S,
                                                     marg_fin)))
            edge_m = to_slots(marg_enc)              # [B, C_loc, Dc]
            em_nan = edge_m > _NAN_MIN
            em_p = (edge_m > _INF_MIN) & ~em_nan
            em_n = edge_m < -_INF_MIN
            v2c_new = jnp.where(em_p, jnp.where(pinf_i, NAN_S, INF_S),
                                edge_m - fin_v)
            v2c_new = jnp.where(em_n, jnp.where(ninf_i, NAN_S, -INF_S),
                                v2c_new)
            v2c_new = jnp.where(em_nan, NAN_S, v2c_new)
            return x_new.astype(jnp.int32), jnp.where(mask, v2c_new, 0.0)

        def body(s):
            if self.inf_policy == "reference":
                x_new, v2c_new = ref_step(s.v2c)
            else:
                c2v = self._check_rows(s.v2c, mask)  # [B, C_loc, Dc]
                marginal = llr + sum_per_var(c2v)    # ONE psum / iteration
                v2c_new = jnp.where(mask, to_slots(marginal) - c2v, 0.0)
                x_new = (marginal < 0).astype(jnp.int32)
            active = ~s.done
            x_hat = jnp.where(active[:, None], x_new, s.x_hat)
            v2c = jnp.where(active[:, None, None], v2c_new, s.v2c)
            iters = s.iters + active.astype(jnp.int32)
            done = s.done | syndrome_ok(x_hat)
            return S(v2c, x_hat, done, done.all(), iters, s.it + 1)

        init = S(v2c0, x0, done0, done0.all(),
                 jnp.zeros(B, jnp.int32), jnp.zeros((), jnp.int32))
        final = lax.while_loop(cond, body, init)
        return final.x_hat, final.iters

    def decode(self, llr: jnp.ndarray, key=None) -> tuple:
        llr = llr.astype(jnp.float32)
        x0 = (llr < 0).astype(jnp.int32)
        return self._decode(self.tables, llr, x0)
