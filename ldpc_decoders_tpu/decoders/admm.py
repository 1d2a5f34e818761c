"""Batched ADMM LP decoding (Barman/Liu-Draper decomposition).

Functional batched re-design of reference src/admm.py:9-77. The reference
iterates one codeword at a time, crossing a Python->ctypes->C++ boundary
for every check projection every iteration (admm.py:61-62 ->
exact.proj_csr -> projection.cpp). Here the whole batch iterates inside
one ``lax.while_loop`` and the projection is the fixed-shape batched
kernel in :mod:`ldpc_decoders_tpu.ops.projection` — all checks of all
codewords project in one fused device op.

Semantics preserved (admm.py:42-69):
- x-update  x = clip((sum_cols(z - lam/mu) - gamma/mu) / var_deg, 0, 1);
- z-update  z = Pi_PP(x_on_edges + lam/mu) per check row;
- dual      lam += mu * (x_on_edges - z);
- converged when ||x_e - z_new||^2 < eps^2 * E  and
  ||z_old - z_new||^2 < eps^2 * E (per codeword; admm.py:15-25);
- ``max_iter <= 0`` means run until convergence (admm.py:53), mapped to a
  configurable safety cap like the BP decoders;
- output through ``pseudo_to_cw`` (math_utils.py:28-34): hard 0.5
  threshold, or with ``allow_pseudo`` snap-to-integral only within 1e-8 so
  fractional pseudo-codewords remain fractional and count as bit errors.

Iteration stats: ``decode`` returns per-word iteration counts recorded the
way the reference's histogram does (admm.py:47-50): a word converging
after its k-th update records k-1; a word still running at the cap records
the cap. The harness aggregates these into the same histogram + average
surfaced by ``stats()`` (admm.py:36-40).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ldpc_decoders_tpu.ops import perm as perm_ops
from ldpc_decoders_tpu.ops.graph import TannerGraph
from ldpc_decoders_tpu.ops.projection import project_parity_polytope
from ldpc_decoders_tpu.utils.math import pseudo_to_cw_jnp


class ADMMState(NamedTuple):
    x: jnp.ndarray        # [B, V] fractional estimate
    z: jnp.ndarray        # [B, C, Dc] replica variables (check layout)
    lam: jnp.ndarray      # [B, C, Dc] scaled duals (check layout)
    done: jnp.ndarray     # [B] bool (converged; frozen)
    updates: jnp.ndarray  # [B] int32 number of x/z/lam updates applied
    it: jnp.ndarray       # scalar int32


class ADMMDecoder:
    """Batched ADMM decoder. decode(llr [B, V]) -> (x_hat, iters)."""

    id_keys = ["mu", "eps", "max_iter", "allow_pseudo"]
    track_iter_hist = True  # harness aggregates the reference's stats()

    def __init__(self, graph: TannerGraph, mu: float = 3.0, eps: float = 1e-5,
                 max_iter: int = 10, allow_pseudo: bool = False,
                 iter_cap: int = 2000, perm: str = "auto", **_):
        self.graph = graph
        self.mu = float(mu)
        self.eps = float(eps)
        self.max_iter = int(max_iter)
        self.allow_pseudo = bool(allow_pseudo)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        # Convergence threshold eps^2 * nnz(H) (reference admm.py:15).
        self.thresh = self.eps ** 2 * graph.n_edge
        # ADMM iterates float32 state whose trajectory is precision-
        # sensitive, so the matmul route runs at Precision.HIGHEST (IEEE
        # float32 on the GPU). "auto" gathers: 1.5x (LDPC(1200,3,6), cap
        # 50) to 2.5x (margulis, cap 200) faster than the one-hot dots on
        # the H100 (PERF.md "Bring-up on the H100").
        if perm == "auto":
            perm = "gather"
        if perm not in ("gather", "matmul"):
            raise ValueError(f"unknown perm mode {perm!r}")
        self.perm = perm
        if perm == "matmul":
            self._s_cv = jnp.asarray(perm_ops.var_sum_matrix(graph))
            self._b_vc = jnp.asarray(perm_ops.var_broadcast_matrix(graph))

    # -- per-iteration data movement, mode-dispatched --------------------
    def _sum_per_var(self, chk_vals: jnp.ndarray) -> jnp.ndarray:
        g = self.graph
        B = chk_vals.shape[0]
        if self.perm == "matmul":
            return jnp.dot(chk_vals.reshape(B, -1), self._s_cv,
                           precision=lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
        return g.sum_per_var(g.scatter_chk(chk_vals))

    def _broadcast_var(self, per_var: jnp.ndarray) -> jnp.ndarray:
        g = self.graph
        B = per_var.shape[0]
        if self.perm == "matmul":
            out = jnp.dot(per_var, self._b_vc,
                          precision=lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
            return out.reshape(B, g.n_chk, g.max_chk_deg)
        return g.gather_chk(g.expand_var(per_var), fill=0.0)

    def decode(self, llr: jnp.ndarray, key=None) -> tuple:
        graph = self.graph
        gamma = llr.astype(jnp.float32)
        B = gamma.shape[0]
        var_deg = graph.var_deg.astype(jnp.float32)
        cmask = graph.chk_mask                      # [C, Dc]
        z0 = jnp.where(cmask, 0.5, 0.0)

        state = ADMMState(
            x=jnp.zeros((B, graph.n_var), jnp.float32),
            z=jnp.broadcast_to(z0, (B,) + z0.shape),
            lam=jnp.zeros((B,) + z0.shape, jnp.float32),
            done=jnp.zeros(B, dtype=bool),
            updates=jnp.zeros(B, jnp.int32),
            it=jnp.zeros((), jnp.int32),
        )

        def cond(s: ADMMState):
            return (s.it < self.iter_cap) & ~s.done.all()

        def body(s: ADMMState):
            x = jnp.clip(
                (self._sum_per_var(s.z - s.lam / self.mu) - gamma / self.mu)
                / var_deg, 0.0, 1.0)                          # [B, V]
            x_e = self._broadcast_var(x)                       # [B, C, Dc]
            z_new = project_parity_polytope(x_e + s.lam / self.mu,
                                            mask=cmask)
            lam = s.lam + self.mu * (x_e - z_new)

            # Pad slots are zero in x_e, z and lam, so plain sums over the
            # layout equal the reference's edge-vector norms (admm.py:19-25).
            d1 = ((x_e - z_new) ** 2).sum((-1, -2))
            d2 = ((s.z - z_new) ** 2).sum((-1, -2))
            close = (d1 < self.thresh) & (d2 < self.thresh)

            active = ~s.done
            m = active[:, None, None]
            return ADMMState(
                x=jnp.where(active[:, None], x, s.x),
                z=jnp.where(m, z_new, s.z),
                lam=jnp.where(m, lam, s.lam),
                done=s.done | (active & close),
                updates=s.updates + active.astype(jnp.int32),
                it=s.it + 1,
            )

        final = lax.while_loop(cond, body, state)
        x_hat = pseudo_to_cw_jnp(final.x, self.allow_pseudo)
        # Reference histogram index (admm.py:47-53): converged after k
        # updates -> k-1; stopped by the cap -> cap.
        iters = jnp.where(final.done, final.updates - 1, final.updates)
        return x_hat, iters

