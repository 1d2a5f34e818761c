"""Batched LLR-domain belief propagation: SPA and MSA.

Functional batched re-design of reference src/bpa.py. The reference runs one
codeword at a time through scipy.sparse reductions with a Python loop
(bpa.py:27-62); here the decode loop is a ``lax.while_loop`` over batched
message tensors with per-codeword done masks, so thousands of codewords
decode per compiled step.

Layout (performance-critical): messages live permanently in the padded
check layout ``[B, C, Dc]``. The check-node update is then a pure
reduction along the small Dc axis (elementwise work, no data movement),
and each iteration pays exactly TWO permutation gathers (check layout ->
variable layout -> check layout, via precomputed slot maps in
:class:`~ldpc_decoders_tpu.ops.graph.TannerGraph`) instead of the four
edge-vector gathers of the naive formulation. bfloat16 messages
(``msg_dtype``) halve the bytes each hop moves.

Semantics preserved from the reference:

- syndrome early exit checked *before* each iteration (bpa.py:29), so a
  received word that is already a codeword decodes in zero iterations.
  The reference initializes ``x_hat = y`` (bpa.py:19), so on real-valued
  channels (biAWGN) the initial syndrome never passes and at least one BP
  iteration always runs; ``check_init=False`` reproduces that exactly
  (the biAWGN factories set it). Bit-input channels keep the iteration-0
  exit, which is identical to the reference's check on y;
- ``max_iter <= 0`` means run until convergence (bpa.py:28); since a
  compiled loop needs a bound, this maps to a large configurable safety
  cap (``iter_cap``);
- SPA check update 2*atanh(prod tanh(m/2)) (bpa.py:71-75) — computed in
  the numerically stable sign/phi domain (Gallager involution
  phi(x) = -log tanh(x/2)) with exact leave-one-out prefix/suffix sums,
  instead of the reference's total-product-divided-by-self which needs
  inf/NaN patching (bpa.py:35-38);
- MSA sign * leave-one-out min (bpa.py:86-102): min1/min2/argmin in two
  masked reductions, replacing the reference's two argmax passes.

Saturation policy: check messages are finite by construction, capped at
LLR_CLIP = 38 — the reference's *effective* float64 ceiling, where
np.tanh(v/2) rounds to exactly 1.0 and 2*atanh(1-ulp) ~= 37.4
(bpa.py:71-75). Beyond that point the reference emits literal +-inf and
relies on inf-inf -> NaN -> 0 patching (bpa.py:35-38); we stay saturated
at the cap instead, which differs only for words whose every message has
already reached float64-certainty (statistically invisible in any
golden-resolvable WER region, validated member-by-member against the
reference ensembles). The cap level matters: an earlier phi(1e-7) ~= 16.8
cap measurably raised the SPA error floor on irregular ensembles (z ~ +13
vs goldens at BSC low crossover) because trapping-set escapes depend on
how much confidence the converged part of the graph can accumulate.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ldpc_decoders_tpu.ops import perm as perm_ops
from ldpc_decoders_tpu.ops.graph import (
    TannerGraph,
    exclusive_sign_parity,
    exclusive_sum,
)

# float32 phi-domain guards: phi is its own inverse, so clipping its
# argument to [PHI_EPS, LLR_CLIP] with PHI_EPS = phi(LLR_CLIP) caps check
# messages at exactly LLR_CLIP. The cap is set to the reference's
# *effective* float64 saturation: np.tanh(v/2) rounds to 1.0 (a factor of
# exact certainty) at |v| ~ 38, and the largest finite check message
# 2*atanh(1 - ulp) is ~37.4 (bpa.py:71-75 in float64). An earlier cap of
# phi(1e-7) ~= 16.8 produced a measurable SPA error floor on irregular
# codes (trapping-set escapes ride on accumulated extrinsic confidence).
# All intermediate phi values stay in float32 normal range (>= 6e-17).
LLR_CLIP = 38.0
PHI_EPS = 6.27e-17  # = phi(LLR_CLIP) = 2*exp(-38)
# Min-sum messages must NOT be magnitude-capped: on the BSC all LLRs are
# equal multiples of log((1-p)/p) and a cap acts like attenuated min-sum,
# visibly *improving* WER vs the uncapped reference (observed 2-3x lower
# — wrong for behavior parity). This guard only replaces the +inf a
# (nonexistent in real codes) degree-1 check would emit.
MSA_DEG1_GUARD = 1e30

# Sentinel encoding for inf_policy="reference" (see class docstring):
# the message plane stays a single float tensor — +-inf is +-INF_S and
# NaN is NAN_S, so sentinels ride the one-hot matmul permutations exactly
# (1e9 and 2e9 are integers < 2^31, exact in float32 and distinguishable
# in bfloat16), and class tests are magnitude-band comparisons.
INF_S = 1e9
NAN_S = 2e9
_INF_MIN = 5e8    # |v| above this => +-inf class
_NAN_MIN = 1.5e9  # v above this => NaN class


def phi(x: jnp.ndarray) -> jnp.ndarray:
    """Gallager phi(x) = -log(tanh(x/2)), float32-stable over the whole
    ladder [PHI_EPS, LLR_CLIP]: the exp(-x) route loses all precision
    below x ~ 1e-6 (exp(-x) rounds to 1), so small arguments use the
    series -log(tanh(x/2)) = log(2/x) + x^2/12 + O(x^4) instead."""
    small = x < 0.1
    ex = jnp.exp(-x)
    big = jnp.log1p(ex) - jnp.log1p(-jnp.where(small, 0.5, ex))
    ser = jnp.log(2.0 / jnp.where(small, x, 1.0)) + x * x / 12.0
    return jnp.where(small, ser, big)


def spa_check_rows(rows: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """SPA extrinsic messages per check row. [..., C, Dc] -> same."""
    mag = jnp.clip(jnp.abs(rows.astype(jnp.float32)), PHI_EPS, LLR_CLIP)
    ph = jnp.where(mask, phi(mag), 0.0)          # pad: certain, sum-neutral
    neg = jnp.where(mask, rows < 0, False).astype(jnp.int32)
    ext = phi(jnp.clip(exclusive_sum(ph), PHI_EPS, None))
    return (ext * exclusive_sign_parity(neg)).astype(rows.dtype)


def spa_check_rows_ref(rows: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """SPA check update with the reference's float64 inf/NaN semantics
    (bpa.py:71-75 + math_utils.arctanh), sentinel-encoded.

    - a NaN input poisons the whole row (log(NaN) -> NaN row sum);
    - +-inf inputs act as factors of exact +-1 (np.tanh(inf) == 1), as do
      finite inputs past LLR_CLIP ~ 38 where float64 tanh rounds to 1;
    - an output is +-inf iff ALL its leave-one-out factors are saturated
      (product == +-1 exactly -> arctanh -> inf), sign by parity.
    """
    a = rows.astype(jnp.float32)
    mag = jnp.abs(a)
    nan_i = a > _NAN_MIN
    pinf_i = (a > _INF_MIN) & ~nan_i
    ninf_i = a < -_INF_MIN
    fin_i = ~(nan_i | pinf_i | ninf_i)
    sat = mask & (pinf_i | ninf_i | (mag >= LLR_CLIP))
    live = mask & fin_i & (mag < LLR_CLIP)
    neg = (mask & ((fin_i & (a < 0)) | ninf_i)).astype(jnp.int32)

    ph = jnp.where(live, phi(jnp.clip(mag, PHI_EPS, LLR_CLIP)), 0.0)
    phs = exclusive_sum(ph)
    nsat = exclusive_sum(sat.astype(jnp.float32))
    deg = mask.astype(jnp.float32).sum(axis=-1, keepdims=True)
    sgn = exclusive_sign_parity(neg).astype(jnp.float32)

    val = phi(jnp.clip(phs, PHI_EPS, None)) * sgn
    all_sat = nsat > deg - 1.5          # every leave-one-out factor == +-1
    out = jnp.where(all_sat, sgn * INF_S, val)
    nan_row = (mask & nan_i).any(axis=-1, keepdims=True)
    out = jnp.where(nan_row, NAN_S, out)
    return jnp.where(mask, out, 0.0).astype(rows.dtype)


def msa_check_rows(rows: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Min-sum extrinsic messages per check row: sign-parity times
    leave-one-out min via (min1, argmin, min2). [..., C, Dc] -> same."""
    mg = jnp.where(mask, jnp.abs(rows), jnp.inf)
    neg = jnp.where(mask, rows < 0, False).astype(jnp.int32)
    min1 = mg.min(axis=-1, keepdims=True)
    amin = mg.argmin(axis=-1, keepdims=True)
    slot = jnp.arange(mg.shape[-1])
    min2 = jnp.where(slot == amin, jnp.inf, mg).min(axis=-1, keepdims=True)
    ext = jnp.where(slot == amin, min2, min1)
    ext = jnp.minimum(ext, MSA_DEG1_GUARD)
    return (ext * exclusive_sign_parity(neg)).astype(rows.dtype)


class BPState(NamedTuple):
    v2c: jnp.ndarray      # [B, C, Dc] variable-to-check messages
    x_hat: jnp.ndarray    # [B, V] current hard decision (int32)
    done: jnp.ndarray     # [B] bool: syndrome satisfied (frozen)
    iters: jnp.ndarray    # [B] int32: iterations executed per word
    it: jnp.ndarray       # scalar int32 global iteration counter


class BPDecoder:
    """Batched SPA/MSA decoder over a compiled Tanner graph.

    ``decode(llr)`` is pure and jit-compatible: llr [B, V] -> (x_hat
    [B, V] int32, iters [B] int32). ``msg_dtype=jnp.bfloat16`` halves
    message-memory traffic; decisions match float32 on all but ~1e-6 of
    bits (validated against golden BER curves).

    ``perm`` selects how the variable half-iteration moves data:
    - "gather": index-gather through the precomputed slot maps — O(E)
      memory and traffic;
    - "incidence": messages never leave the check layout. The variable
      marginal is ONE [B, E] x [E, V] sum matmul (each column of
      ``a_sum`` one-hots a variable's edge slots) and the leave-one-out
      messages are ``marginal`` broadcast back through its transpose
      minus the incoming message — two [E, V]-shaped dots per iteration
      instead of two [E, E] permutations, same semantics;
    - "matmul": one-hot E x E layout permutations (bit-identical to the
      gather route);
    - "auto": :func:`~ldpc_decoders_tpu.ops.perm.auto_bp_perm`.
    The syndrome check in incidence/matmul mode is likewise one
    x_hat @ H^T matmul (sums are exact in float32 for any realistic
    check degree).
    """

    id_keys = ["max_iter"]

    def __init__(self, graph: TannerGraph, variant: str = "SPA",
                 max_iter: int = 10, iter_cap: int = 1000,
                 msg_dtype=jnp.float32, perm: str = "auto",
                 check_init: bool = True, inf_policy: str = "reference",
                 dot_precision=None, **_):
        # dot_precision overrides the one-hot matmul precision policy
        # (None = HIGHEST for f32 messages, DEFAULT for bf16).
        self._dot_precision_override = (
            lax.Precision(dot_precision) if isinstance(dot_precision, str)
            else dot_precision)
        if variant not in ("SPA", "MSA"):
            raise ValueError(f"unknown BP variant {variant!r}")
        if inf_policy not in ("reference", "saturate"):
            raise ValueError(f"unknown inf_policy {inf_policy!r}")
        self.graph = graph
        self.check_init = bool(check_init)
        self.variant = variant
        # "reference" (SPA only): reproduce the reference's float64
        # inf/NaN dynamics — saturated checks emit literal +-inf, the
        # variable update's inf-inf becomes NaN which virally poisons
        # check rows, and a NaN marginal decides bit 0 (bpa.py:35-38).
        # These dynamics are LOAD-BEARING for the committed golden SPA
        # curves: on codeword=0 runs the poison cascade progressively
        # zeroes stuck words, suppressing the error floor up to ~15x at
        # low noise (validated: IREG member 3, BSC p=0.05, cap 100 —
        # golden WER 0.0144, reference-semantics 0.0159, clean
        # saturating decoder 0.247). "saturate" is the clean
        # policy (messages capped at LLR_CLIP, no poison), preferable
        # for any purpose other than matching the reference's curves.
        self.inf_policy = inf_policy if variant == "SPA" else "saturate"
        self.max_iter = int(max_iter)
        # max_iter <= 0 => run to convergence, bounded by the safety cap.
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        self.msg_dtype = jnp.dtype(msg_dtype)
        self._check_rows = (spa_check_rows if variant == "SPA"
                            else msa_check_rows)
        if perm == "auto":
            perm = perm_ops.auto_bp_perm(graph, self.msg_dtype)
        if perm not in ("incidence", "matmul", "gather"):
            raise ValueError(f"unknown perm mode {perm!r}")
        self.perm = perm
        self.tables = self.member_tables(graph)

    def member_tables(self, graph: TannerGraph,
                      n_edge_pad: int = 0) -> dict:
        """Everything member-specific, as device arrays.

        ``decode``/``decode_tables`` consume ONLY these tables plus
        shape/config attributes, so one compiled program can serve every
        same-padded-shape code in an ensemble: pass another member's
        tables as a traced argument and the executable decodes that
        member (the harness's rotating ensemble path; the reference runs
        such ensembles as 10 independent cluster jobs,
        simulations.py:79-85)."""
        g, dt = graph, self.msg_dtype
        if (g.n_chk, g.n_var, g.max_chk_deg, g.max_var_deg) != (
                self.graph.n_chk, self.graph.n_var,
                self.graph.max_chk_deg, self.graph.max_var_deg):
            raise ValueError("member graph has different padded shapes")
        t = {"cmask": g.chk_mask, "vmask": g.var_mask}
        if self.perm == "incidence":
            t["a_sum"] = jnp.asarray(perm_ops.var_sum_matrix(g), dt)
            t["a_bc"] = jnp.asarray(perm_ops.var_broadcast_matrix(g), dt)
            t["h_t"] = jnp.asarray(perm_ops.parity_matrix_t(g))  # [V, C]
        elif self.perm == "matmul":
            t["p_c2v"] = jnp.asarray(perm_ops.perm_chk_to_var(g), dt)
            t["p_v2c"] = jnp.asarray(perm_ops.perm_var_to_chk(g), dt)
            t["h_t"] = jnp.asarray(perm_ops.parity_matrix_t(g))  # [V, C]
        else:
            t["vs_from_chk"] = g.var_slot_from_chk
            t["cs_from_var"] = g.chk_slot_from_var
        return t

    # -- layout conversion, mode-dispatched -----------------------------
    @property
    def _dot_precision(self):
        # A reduced-precision float32 matmul (TF32 on the GPU's tensor
        # cores, bf16 passes elsewhere) rounds every message per hop —
        # on the BSC (LLRs all equal multiples of log((1-p)/p), heavily
        # tie-structured) that shifted the MSA WER curve ~10 sigma off
        # the reference (docs/PARITY.md "Numerics"). HIGHEST is IEEE
        # float32 on the GPU; for bfloat16 messages the one-hot product
        # is already exact either way.
        if self._dot_precision_override is not None:
            return self._dot_precision_override
        return (lax.Precision.HIGHEST if self.msg_dtype == jnp.float32
                else lax.Precision.DEFAULT)

    def _slot_perm(self, vals: jnp.ndarray, perm_idx: jnp.ndarray,
                   out_nodes: int, out_deg: int) -> jnp.ndarray:
        """Gather-route layout hop through a traced slot permutation."""
        lead = vals.shape[:-2]
        flat = vals.reshape(lead + (vals.shape[-2] * vals.shape[-1],))
        pad = jnp.zeros(lead + (1,), dtype=vals.dtype)
        flat = jnp.concatenate([flat, pad], axis=-1)
        out = jnp.take(flat, perm_idx, axis=-1)
        return out.reshape(lead + (out_nodes, out_deg))

    def _chk_to_var(self, chk_vals: jnp.ndarray, t: dict) -> jnp.ndarray:
        g = self.graph
        if self.perm == "gather":
            return self._slot_perm(chk_vals, t["vs_from_chk"],
                                   g.n_var, g.max_var_deg)
        lead = chk_vals.shape[:-2]
        flat = chk_vals.reshape(lead + (g.n_chk * g.max_chk_deg,))
        out = jnp.dot(flat, t["p_c2v"], precision=self._dot_precision,
                      preferred_element_type=chk_vals.dtype)
        return out.reshape(lead + (g.n_var, g.max_var_deg))

    def _var_to_chk(self, var_vals: jnp.ndarray, t: dict) -> jnp.ndarray:
        g = self.graph
        if self.perm == "gather":
            return self._slot_perm(var_vals, t["cs_from_var"],
                                   g.n_chk, g.max_chk_deg)
        lead = var_vals.shape[:-2]
        flat = var_vals.reshape(lead + (g.n_var * g.max_var_deg,))
        out = jnp.dot(flat, t["p_v2c"], precision=self._dot_precision,
                      preferred_element_type=var_vals.dtype)
        return out.reshape(lead + (g.n_chk, g.max_chk_deg))

    def _syndrome_ok(self, x_hat: jnp.ndarray, t: dict) -> jnp.ndarray:
        """[B, V] bits -> [B] bool."""
        g = self.graph
        if self.perm in ("incidence", "matmul"):
            # 0/1 operands and integer sums <= check degree: exact at
            # any matmul precision, TF32 included.
            s = jnp.dot(x_hat.astype(jnp.float32), t["h_t"],
                        preferred_element_type=jnp.float32)
            return (s.astype(jnp.int32) % 2 == 0).all(axis=-1)
        bits = jnp.broadcast_to(
            x_hat[..., None], x_hat.shape + (g.max_var_deg,))
        per_chk = self._var_to_chk(bits, t)
        return (per_chk.sum(axis=-1) % 2 == 0).all(axis=-1)

    def _init_v2c(self, t: dict, llr: jnp.ndarray) -> jnp.ndarray:
        """Channel priors on every edge, check layout (bpa.py:19)."""
        g, dt = self.graph, self.msg_dtype
        B = llr.shape[0]
        if self.perm == "incidence":
            flat = jnp.dot(llr.astype(t["a_bc"].dtype), t["a_bc"],
                           precision=self._dot_precision,
                           preferred_element_type=jnp.float32)
            return flat.reshape(B, g.n_chk, g.max_chk_deg).astype(dt)
        pri = jnp.broadcast_to(llr[:, :, None], llr.shape + (g.max_var_deg,))
        return self._var_to_chk(pri.astype(dt), t)

    def _var_update(self, t: dict, llr: jnp.ndarray,
                    c2v: jnp.ndarray) -> tuple:
        """Variable half-iteration from check-layout extrinsics ``c2v``:
        returns (marginal [B, V] float32, v2c_new [B, C, Dc] msg dtype).

        incidence mode: marginal = llr + c2v_flat @ a_sum (pads excluded
        by construction — a_sum has no row for fill slots), and the
        leave-one-out messages marginal[var(e)] - c2v[e] come from ONE
        broadcast dot through a_bc, never leaving the check layout.
        matmul/gather modes: hop to the var layout, sum, subtract, hop
        back (reference bpa.py:35-38 semantics either way)."""
        g, dt = self.graph, self.msg_dtype
        B = llr.shape[0]
        if self.perm == "incidence":
            flat = c2v.reshape(B, g.n_chk * g.max_chk_deg)
            msum = jnp.dot(flat, t["a_sum"],
                           precision=self._dot_precision,
                           preferred_element_type=jnp.float32)
            marginal = llr + msum
            edge_m = jnp.dot(marginal.astype(t["a_bc"].dtype), t["a_bc"],
                             precision=self._dot_precision,
                             preferred_element_type=jnp.float32)
            v2c_new = (edge_m.reshape(c2v.shape)
                       - flat.astype(jnp.float32).reshape(c2v.shape))
            return marginal, v2c_new.astype(dt)
        vmask = t["vmask"]
        c2v_var = self._chk_to_var(c2v, t).astype(jnp.float32)
        marginal = llr + jnp.where(vmask, c2v_var, 0.0).sum(-1)
        v2c_var = (marginal[:, :, None] - c2v_var).astype(dt)
        return marginal, self._var_to_chk(v2c_var, t)

    # -- reference inf/NaN semantics (SPA parity mode) -------------------
    def _var_agg(self, planes: jnp.ndarray, t: dict) -> jnp.ndarray:
        """Sum stacked check-layout planes [B, P, C, Dc] per variable ->
        [B, P, V] (pads excluded on every route)."""
        g = self.graph
        if self.perm == "incidence":
            lead = planes.shape[:-2]
            flat = planes.reshape(lead + (g.n_chk * g.max_chk_deg,))
            return jnp.dot(flat.astype(t["a_sum"].dtype), t["a_sum"],
                           precision=self._dot_precision,
                           preferred_element_type=jnp.float32)
        per_var = self._chk_to_var(planes, t).astype(jnp.float32)
        return jnp.where(t["vmask"], per_var, 0.0).sum(axis=-1)

    def _var_broadcast(self, marg: jnp.ndarray, t: dict) -> jnp.ndarray:
        """Broadcast per-variable values [B, V] to their edges in check
        layout -> [B, C, Dc]."""
        g = self.graph
        B = marg.shape[0]
        if self.perm == "incidence":
            flat = jnp.dot(marg.astype(t["a_bc"].dtype), t["a_bc"],
                           precision=self._dot_precision,
                           preferred_element_type=jnp.float32)
            return flat.reshape(B, g.n_chk, g.max_chk_deg)
        per_var = jnp.broadcast_to(
            marg[:, :, None], marg.shape + (g.max_var_deg,))
        return self._var_to_chk(per_var, t).astype(jnp.float32)

    def _spa_ref_step(self, t: dict, llr: jnp.ndarray,
                      v2c: jnp.ndarray) -> tuple:
        """One SPA iteration under inf_policy="reference": returns
        (x_new [B, V] int32, v2c_new). Mirrors bpa.py:31-62 float64
        behavior: marginal = priors + sum(c2v) with IEEE inf arithmetic,
        NaN marginal -> bit 0, v2c = marginal - c2v computed BEFORE the
        NaN zeroing so inf-inf poisons the edge for good."""
        cmask = t["cmask"]
        c2v = spa_check_rows_ref(v2c, cmask).astype(jnp.float32)

        nan_i = c2v > _NAN_MIN
        pinf_i = (c2v > _INF_MIN) & ~nan_i
        ninf_i = c2v < -_INF_MIN
        fin_v = jnp.where(nan_i | pinf_i | ninf_i, 0.0, c2v)
        # A NaN input is counted as +inf AND -inf at once: the marginal
        # class rule "conflicting infinities -> NaN" then absorbs the
        # dedicated NaN plane, so the aggregation is 3 dots, not 4.
        planes = jnp.stack(
            [fin_v, (pinf_i | nan_i).astype(jnp.float32),
             (ninf_i | nan_i).astype(jnp.float32)], axis=1)  # [B, 3, C, Dc]
        sums = self._var_agg(planes, t)                  # [B, 3, V]
        fin_sum, n_p, n_n = sums[:, 0], sums[:, 1], sums[:, 2]

        is_nan = (n_p > 0.5) & (n_n > 0.5)
        is_p = ~is_nan & (n_p > 0.5)
        is_n = ~is_nan & (n_n > 0.5)
        marg_fin = llr + fin_sum
        # NaN marginal is zeroed before the hard decision (bpa.py:37) so
        # it decides bit 0, exactly like +inf; -inf decides bit 1.
        x_new = jnp.where(is_n, 1,
                          jnp.where(is_nan | is_p, 0,
                                    (marg_fin < 0).astype(jnp.int32)))
        marg_enc = jnp.where(is_nan, NAN_S,
                             jnp.where(is_p, INF_S,
                                       jnp.where(is_n, -INF_S, marg_fin)))

        edge_m = self._var_broadcast(marg_enc, t)        # [B, C, Dc]
        em_nan = edge_m > _NAN_MIN
        em_p = (edge_m > _INF_MIN) & ~em_nan
        em_n = edge_m < -_INF_MIN
        v2c_new = jnp.where(em_p, jnp.where(pinf_i, NAN_S, INF_S),
                            edge_m - fin_v)
        v2c_new = jnp.where(em_n, jnp.where(ninf_i, NAN_S, -INF_S), v2c_new)
        v2c_new = jnp.where(em_nan, NAN_S, v2c_new)
        v2c_new = jnp.where(cmask, v2c_new, 0.0)
        return x_new.astype(jnp.int32), v2c_new.astype(self.msg_dtype)

    def _bp_step(self, t: dict, llr: jnp.ndarray, v2c: jnp.ndarray) -> tuple:
        """One BP iteration: (x_new [B, V] int32, v2c_new [B, C, Dc])."""
        if self.variant == "SPA" and self.inf_policy == "reference":
            return self._spa_ref_step(t, llr, v2c)
        c2v = self._check_rows(v2c, t["cmask"])
        marginal, v2c_new = self._var_update(t, llr, c2v)
        return (marginal < 0).astype(jnp.int32), v2c_new

    def decode(self, llr: jnp.ndarray, key=None) -> tuple:
        return self.decode_tables(self.tables, llr, key)

    def decode_tables(self, t: dict, llr: jnp.ndarray, key=None) -> tuple:
        """Pure decode over *traced* member tables (see
        :meth:`member_tables`)."""
        llr = llr.astype(jnp.float32)
        B = llr.shape[0]

        x0 = (llr < 0).astype(jnp.int32)
        done0 = (self._syndrome_ok(x0, t) if self.check_init
                 else jnp.zeros(B, bool))
        state = BPState(
            v2c=self._init_v2c(t, llr),
            x_hat=x0,
            done=done0,
            iters=jnp.zeros(B, dtype=jnp.int32),
            it=jnp.zeros((), dtype=jnp.int32),
        )

        def cond(s: BPState):
            return (s.it < self.iter_cap) & ~s.done.all()

        def body(s: BPState):
            x_new, v2c_new = self._bp_step(t, llr, s.v2c)

            active = ~s.done
            x_hat = jnp.where(active[:, None], x_new, s.x_hat)
            v2c = jnp.where(active[:, None, None], v2c_new, s.v2c)
            iters = s.iters + active.astype(jnp.int32)
            done = s.done | self._syndrome_ok(x_hat, t)
            return BPState(v2c, x_hat, done, iters, s.it + 1)

        final = lax.while_loop(cond, body, state)
        return final.x_hat, final.iters

    def decode_multi_cap(self, llr: jnp.ndarray, caps, key=None) -> tuple:
        """One decode pass, results AT EVERY iteration cap in ``caps``.

        The reference studies the iteration-cap effect by re-running the
        whole Monte-Carlo per cap (simulations.py:74-77 REG_BAD: 8 caps x
        5 sweeps as separate jobs). But a BP word's trajectory does not
        depend on the cap — hard decisions freeze once the syndrome
        passes and evolve identically otherwise — so ONE pass bounded by
        max(caps) can snapshot the running decisions at each cap:
        ``x_hats[k]`` is bit-exactly ``decode`` with ``iter_cap=caps[k]``
        and ``iters[k] = min(iters, caps[k])``.

        ``caps``: static ascending sequence of positive ints.
        Returns (x_hats [K, B, V] int32, iters [K, B] int32).
        """
        caps = tuple(int(c) for c in caps)
        assert list(caps) == sorted(caps) and caps[0] >= 1
        t = self.tables
        llr = llr.astype(jnp.float32)
        B = llr.shape[0]
        caps_arr = jnp.asarray(caps, jnp.int32)

        x0 = (llr < 0).astype(jnp.int32)
        done0 = (self._syndrome_ok(x0, t) if self.check_init
                 else jnp.zeros(B, bool))
        snap0 = jnp.broadcast_to(x0[None], (len(caps),) + x0.shape)
        state = (BPState(
            v2c=self._init_v2c(t, llr),
            x_hat=x0, done=done0,
            iters=jnp.zeros(B, dtype=jnp.int32),
            it=jnp.zeros((), dtype=jnp.int32)), snap0)

        def cond(ss):
            s, _ = ss
            return (s.it < caps[-1]) & ~s.done.all()

        def body(ss):
            s, snap = ss
            x_new, v2c_new = self._bp_step(t, llr, s.v2c)

            active = ~s.done
            x_hat = jnp.where(active[:, None], x_new, s.x_hat)
            v2c = jnp.where(active[:, None, None], v2c_new, s.v2c)
            iters = s.iters + active.astype(jnp.int32)
            done = s.done | self._syndrome_ok(x_hat, t)
            hit = caps_arr == (s.it + 1)                       # [K]
            snap = jnp.where(hit[:, None, None], x_hat[None], snap)
            return BPState(v2c, x_hat, done, iters, s.it + 1), snap

        final, snap = lax.while_loop(cond, body, state)
        # Caps the (early-exited) loop never reached hold the final state.
        snap = jnp.where((caps_arr > final.it)[:, None, None],
                         final.x_hat[None], snap)
        iters_k = jnp.minimum(final.iters[None], caps_arr[:, None])
        return snap, iters_k
