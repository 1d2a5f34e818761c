"""Batched exhaustive-codebook maximum-likelihood decoders.

Capability parity with the per-channel ML classes of the reference
(bsc.py:63-75, bec.py:21-36, biawgn.py:66-78) — the exactness oracle used
throughout the reference's test strategy (SURVEY.md section 4).

Batched design: the codebook scoring reduces to one matmul per batch
([B, n] x [n, 2^k]):

- BSC: log-likelihood is affine in the agreement count, and the agreement
  count is affine in (2y-1) . (2c-1);
- biAWGN: -||(2c-1) - y||^2 is affine in y . (2c-1) because ||2c-1||^2 = n;
- BEC: a codeword is feasible iff it matches every non-erased symbol; all
  feasible codewords are equally likely, so ML = uniform choice among
  them. Feasibility count is again a matmul over indicator encodings.

Random argmax tie-breaking (reference math_utils.py:72-74) is reproduced
in-batch: uniform random keys masked to the argmax set.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def arg_max_rand_batched(values: jnp.ndarray, key) -> jnp.ndarray:
    """[B, K] -> [B]: argmax index, ties broken uniformly at random."""
    vmax = values.max(axis=-1, keepdims=True)
    is_max = values >= vmax
    r = jax.random.uniform(key, values.shape)
    return jnp.argmax(jnp.where(is_max, r, -1.0), axis=-1)


class MLDecoderBase:
    id_keys: list = []

    def __init__(self, code, **_):
        if code.cb is None:
            raise ValueError("ML decoding needs the enumerated codebook "
                             "(generator matrix required)")
        self.cb = jnp.asarray(code.cb, dtype=jnp.float32)        # [K, n]
        self.cb_pm = 2.0 * self.cb - 1.0                          # [K, n]
        self.n = code.get_n()


class MLBSC(MLDecoderBase):
    """ML for the binary symmetric channel (reference bsc.py:63-75)."""

    def decode(self, y: jnp.ndarray, p, key) -> jnp.ndarray:
        y_pm = 2.0 * y.astype(jnp.float32) - 1.0                  # [B, n]
        # agrees = (n + y_pm . cb_pm) / 2 ; log_prob affine in agrees.
        # +-1 operands and integer sums <= n: exact at any matmul
        # precision, TF32 included.
        agree2 = jnp.dot(y_pm, self.cb_pm.T,
                         preferred_element_type=jnp.float32)      # [B, K]
        log_p, log_1p = jnp.log(p), jnp.log1p(-p)
        # log_prob = diffs*log_p + agrees*log_1p with agrees=(n+a2)/2
        log_prob = (self.n - (self.n + agree2) / 2) * log_p \
            + ((self.n + agree2) / 2) * log_1p
        idx = arg_max_rand_batched(log_prob, key)
        return self.cb[idx].astype(jnp.int32)


class MLBiAWGN(MLDecoderBase):
    """ML for the biAWGN channel (reference biawgn.py:66-78)."""

    def decode(self, y: jnp.ndarray, snr_db, key) -> jnp.ndarray:
        # argmax of -||cb_pm - y||^2 = argmax of y . cb_pm (||cb_pm||^2 = n).
        # HIGHEST precision (IEEE float32 on the GPU): a reduced-precision
        # matmul (TF32) rounds the real-valued y, making the "exact
        # oracle" non-ML on near-tie words (BSC/BEC scores are exactly
        # representable and unaffected).
        score = jnp.dot(y.astype(jnp.float32), self.cb_pm.T,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32)       # [B, K]
        idx = arg_max_rand_batched(score, key)
        return self.cb[idx].astype(jnp.int32)


class MLBEC(MLDecoderBase):
    """ML for the erasure channel: uniform choice among codewords that
    agree with every non-erased position (reference bec.py:21-36 assigns
    -inf to any codeword with a disagreement; survivors tie)."""

    def decode(self, y: jnp.ndarray, p, key) -> jnp.ndarray:
        y = y.astype(jnp.int32)                                   # [B, n]
        erased = (y == 2)
        # disagreements on non-erased positions:
        # cb [K, n] vs y [B, n] -> count via one-hot matmuls.
        y0 = jnp.where(~erased, (y == 0).astype(jnp.float32), 0.0)
        y1 = jnp.where(~erased, (y == 1).astype(jnp.float32), 0.0)
        # codeword bit 1 disagrees with observed 0 and vice versa; 0/1
        # operands and integer sums <= n are exact at any matmul
        # precision, TF32 included.
        diffs = jnp.dot(y0, self.cb.T, preferred_element_type=jnp.float32) \
            + jnp.dot(y1, (1.0 - self.cb).T,
                      preferred_element_type=jnp.float32)         # [B, K]
        feasible = diffs == 0
        r = jax.random.uniform(key, feasible.shape)
        idx = jnp.argmax(jnp.where(feasible, r, -1.0), axis=-1)
        return self.cb[idx].astype(jnp.int32)
