"""Iteration-cap sweep runner: every max_iter variant in ONE program.

The reference's REG_BAD campaign re-runs the full Monte-Carlo once per
iteration cap (simulations.py:74-77: caps {0,1,2,3,6,10,40,100} x 5
channel/decoder sweeps = 40 cluster jobs). A BP word's trajectory does
not depend on the cap, so
:meth:`~ldpc_decoders_tpu.decoders.bp.BPDecoder.decode_multi_cap`
snapshots the running decisions at every cap in one pass — this runner
Monte-Carlos ALL caps simultaneously: per-cap tallies, per-cap adaptive
``min_wec`` termination, and one Saver per cap writing the same files a
per-cap run would (plotting stays oblivious).

Per-cap estimates share noise realizations (correlated across caps,
unbiased individually — exactly like comparing decoders on common
randomness, a variance *reduction* for cap-to-cap contrasts).

max_iter label semantics (golden-vintage calibrated):
- label > 0: iteration cap, current reference semantics (bpa.py:28);
- label = 0: NO decoding — the tally scores the raw channel output.
  The reference's committed ``*-SPA-0-0.json`` goldens all have WER = 1
  and (on biAWGN) BER = 1: at that code vintage ``max_iter=0`` returned
  ``x_hat = y`` untouched, and on biAWGN the *real-valued* y never
  equals a bit, so every bit scored as an error. (The CURRENT reference
  code would instead loop without a cap — a different, later semantics
  reachable here with a negative label.) We reproduce the goldens:
  bec/bsc tally y itself (erasures are errors); biawgn tallies every
  bit as an error;
- label < 0: run to convergence (current reference ``max_iter <= 0``
  semantics; the ``iter_cap`` safety bound applies — curves saturate
  far below it).
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict, deque
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_decoders_tpu.channels import CHANNELS
from ldpc_decoders_tpu.codes import get_code
from ldpc_decoders_tpu.decoders.bec_spa import BECSPADecoder
from ldpc_decoders_tpu.decoders.bp import BPDecoder
from ldpc_decoders_tpu.harness.runner import RunConfig, _start_host_copy
from ldpc_decoders_tpu.harness.saver import Saver


class CapSweepRunner:
    """One (channel, code, decoder) sweep tallied at several iteration
    caps at once. ``cap_labels`` are max_iter values as the reference
    spells them (0 = converge); decode runs once to the largest effective
    cap. BP families only (SPA/MSA, ternary SPA on bec) — the exact
    workloads of the reference's REG_BAD grid."""

    def __init__(self, cfg: RunConfig, cap_labels: Sequence[int]):
        self.cfg = cfg
        self.mod = CHANNELS[cfg.channel]
        self.code = get_code(cfg.code)
        self.cap_labels = list(cap_labels)
        # label 0 = raw channel output (slot 0 of the tally, no decode);
        # label < 0 = converge (iter_cap); label > 0 = that cap.
        effective = [0 if c == 0 else (c if c > 0 else cfg.iter_cap)
                     for c in self.cap_labels]
        order = np.argsort(effective, kind="stable")
        self.order = order                       # ascending-cap order
        self.caps = [int(effective[i]) for i in order if effective[i] > 0]
        self.n_zero = sum(1 for e in effective if e == 0)
        if self.n_zero > 1:
            raise ValueError("at most one raw-output (0) cap label")
        if len(set(self.caps)) != len(self.caps):
            raise ValueError(f"duplicate effective caps: {self.caps}")
        self.K = self.n_zero + len(self.caps)

        if cfg.decoder not in ("SPA", "MSA"):
            raise ValueError("cap sweep supports BP decoders only")
        if not self.caps:
            raise ValueError("need at least one decoding cap label")
        kw = dict(max_iter=self.caps[-1], iter_cap=cfg.iter_cap,
                  msg_dtype=jnp.dtype(cfg.msg_dtype),
                  inf_policy=cfg.inf_policy)
        if cfg.channel == "bec":
            # Ternary-message BEC SPA has no saturation/inf path — any
            # inf_policy is honored trivially.
            self.dec = BECSPADecoder(self.code.graph, **kw)
        else:
            self.dec = BPDecoder(self.code.graph, cfg.decoder,
                                 check_init=(cfg.channel != "biawgn"), **kw)

        self.log = logging.getLogger(".".join(
            [cfg.channel, cfg.code, cfg.decoder, "caps"]))
        self.savers = []
        if cfg.data_dir:
            for lbl_idx in order:
                lbl = self.cap_labels[lbl_idx]
                ids = [("channel", cfg.channel), ("code", cfg.code),
                       ("decoder", cfg.decoder), ("codeword", cfg.codeword),
                       ("min_wec", cfg.min_wec), ("max_iter", lbl)]
                self.savers.append(Saver(cfg.data_dir, ids))

        self._chunk = jax.jit(self._chunk_body)

    def _chunk_body(self, key, i, param):
        cfg = self.cfg
        B = cfg.batch
        n = self.code.get_n()
        kc, kd = jax.random.split(jax.random.fold_in(key, i))
        x = jnp.full((B, n), cfg.codeword, jnp.int32)
        y = self.mod.send(kc, x, param)
        if cfg.channel == "bec":
            x_hats, _ = self.dec.decode_multi_cap(y, self.caps)
        else:
            x_hats, _ = self.dec.decode_multi_cap(
                self.mod.llr(y, param), self.caps)
        errs = (x_hats != x[None]).sum(axis=-1)          # [K', B]
        if self.n_zero:
            if cfg.channel == "biawgn":
                # golden vintage: raw REAL y scored against bits — every
                # bit is an error.
                errs0 = jnp.full((1, B), n, errs.dtype)
            else:
                errs0 = (y != x).sum(axis=-1)[None]      # bec: 2 != bit
            errs = jnp.concatenate([errs0, errs], axis=0)
        # ONE packed [2, K] tally array = ONE device->host fetch per chunk
        # (see MonteCarloRunner._chunk_body).
        return jnp.stack([(errs > 0).sum(axis=-1),
                          errs.sum(axis=-1)]).astype(jnp.int32)

    def run_param(self, param: float, key) -> list:
        cfg = self.cfg
        tot = 0
        wec = np.zeros(self.K, np.int64)
        bec = np.zeros(self.K, np.int64)
        t_start = t_log = time.time()
        t_warm = None
        tot_warm = 0

        def cap_status(k) -> OrderedDict:
            wer = wec[k] / tot if tot else 0.0
            ber = bec[k] / (tot * self.code.get_n()) if tot else 0.0
            vals = OrderedDict([("tot", int(tot)), ("wec", int(wec[k])),
                                ("wer", float(wer)), ("bec", int(bec[k])),
                                ("ber", float(ber))])
            if t_warm is not None and tot > tot_warm:
                wps = (tot - tot_warm) / (time.time() - t_warm)
            else:
                elapsed = time.time() - t_start
                wps = tot / elapsed if elapsed > 0 else 0.0
            vals["words_per_sec"] = float(wps)
            return vals

        def log_and_save():
            self.log.info("TOT:%d (x%d caps), WEC:[%d..%d]",
                          tot, self.K, wec.min(), wec.max())
            for k, saver in enumerate(self.savers):
                saver.add(param, cap_status(k))

        pending: deque = deque()
        depth = max(1, int(cfg.pipeline))

        def consume():
            nonlocal tot, t_warm, tot_warm
            arr = np.asarray(pending.popleft(), np.int64)
            wec[:] += arr[0]
            bec[:] += arr[1]
            tot += cfg.batch
            if t_warm is None:
                t_warm = time.time()
                tot_warm = tot

        chunk_i = 0
        # Larger caps can only have fewer errors, so the largest cap is
        # the last to cross min_wec; still check all (ties at saturation).
        while (wec < cfg.min_wec).any():
            chunk_i += 1
            pending.append(_start_host_copy(
                self._chunk(key, chunk_i, param)))
            if len(pending) >= depth:
                consume()
            if time.time() - t_log > cfg.log_freq:
                t_log = time.time()
                log_and_save()
            if cfg.max_words and tot + cfg.batch * len(pending) >= cfg.max_words:
                self.log.warning("max_words cap hit at %d", tot)
                break
        while pending:
            consume()

        log_and_save()
        return [cap_status(k) for k in range(self.K)]

    def run(self) -> dict:
        """Full sweep. Returns {cap_label: {param: metrics}} (labels in
        the caller's original order)."""
        key = jax.random.PRNGKey(self.cfg.seed)
        results = {lbl: {} for lbl in self.cap_labels}
        for param in self.cfg.params:
            self.log.info("Starting parameter: %f (K=%d caps)",
                          param, self.K)
            key, sub = jax.random.split(key)
            stats = self.run_param(param, sub)
            for k, lbl_idx in enumerate(self.order):
                results[self.cap_labels[lbl_idx]][param] = stats[k]
        self.log.info("Done!")
        return results
