"""Ensemble Monte-Carlo runner: the whole code ensemble in ONE program.

The reference sweeps a 10-member random-code ensemble as 10 independent
cluster jobs (simulations.py:79-85 REG_ENS); running them through
:class:`MonteCarloRunner` re-jits per member because each member's edge
tables are compile-time constants (~3 min compile for ~20 s of decode
each, measured). Here the members' one-hot tables are stacked on a
leading [G] axis and the decode vmaps over it
(:mod:`~ldpc_decoders_tpu.decoders.bp_ensemble`), so one compilation and
one device program Monte-Carlos every member simultaneously: chunks are
[G, B, V], tallies are per-member [G], and the adaptive ``min_wec``
termination (reference main.py:37) applies per member — finished members
keep accumulating (harmless, unbiased) until the slowest one crosses.

Each member writes through its own Saver with the same file naming a
per-member run would produce, so plotting and golden comparisons are
oblivious to how the results were generated.

Multi-chip: with a mesh, the batch axis shards per device inside each
member ([G, B/ndev, V]) and per-member tallies psum across devices.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import OrderedDict, deque
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ldpc_decoders_tpu.channels import CHANNELS
from ldpc_decoders_tpu.codes import get_code
from ldpc_decoders_tpu.decoders.bp_ensemble import (
    EnsembleBECSPADecoder,
    EnsembleBPDecoder,
)
from ldpc_decoders_tpu.harness.runner import RunConfig
from ldpc_decoders_tpu.harness.saver import Saver


class EnsembleMonteCarloRunner:
    """One (channel, decoder) sweep over G same-shape ensemble members.

    ``cfg.code`` is only a display label; ``member_names`` are resolved
    through the code registry. Supports the BP decoder families (SPA/MSA
    on bsc/biawgn, ternary SPA on bec — the reference's ensemble
    campaigns use exactly these, simulations.py:27-39).
    """

    def __init__(self, cfg: RunConfig, member_names: Sequence[str],
                 mesh: Optional[jax.sharding.Mesh] = None):
        if cfg.decoder not in ("SPA", "MSA"):
            raise ValueError("ensemble runner supports SPA/MSA only")
        if cfg.codeword == -1:
            raise ValueError("ensemble members are parity-only codes; "
                             "random-codeword mode needs a generator")
        self.cfg = cfg
        self.mesh = mesh
        self.member_names = list(member_names)
        self.mod = CHANNELS[cfg.channel]
        self.codes = [get_code(n) for n in self.member_names]
        graphs = [c.graph for c in self.codes]
        self.n_var = graphs[0].n_var
        self.G = len(graphs)

        kw = dict(max_iter=cfg.max_iter, iter_cap=cfg.iter_cap,
                  msg_dtype=jnp.dtype(cfg.msg_dtype),
                  inf_policy=cfg.inf_policy)
        if cfg.channel == "bec":
            # Reference aliases MSA = SPA on the BEC (bec.py:125). The
            # ternary-message BEC SPA has no saturation/inf path, so any
            # inf_policy is honored trivially (messages are in {-1,0,1}).
            self.dec = EnsembleBECSPADecoder(graphs, **kw)
        else:
            self.dec = EnsembleBPDecoder(
                graphs, cfg.decoder,
                check_init=(cfg.channel != "biawgn"), **kw)

        self.log = logging.getLogger(
            ".".join([cfg.channel, cfg.code, cfg.decoder, "ensemble"]))
        self.savers = []
        if cfg.data_dir:
            for name in self.member_names:
                ids = [("channel", cfg.channel), ("code", name),
                       ("decoder", cfg.decoder), ("codeword", cfg.codeword),
                       ("min_wec", cfg.min_wec), ("max_iter", cfg.max_iter)]
                self.savers.append(Saver(cfg.data_dir, ids))

        if mesh is not None:
            if cfg.batch % mesh.devices.size:
                raise ValueError("batch must divide evenly over the mesh")
            self._chunk = self._build_sharded_chunk(mesh)
        else:
            self._chunk = jax.jit(self._chunk_body)

    # ------------------------------------------------------------------
    def _chunk_body(self, key, i, param, tables,
                    batch: Optional[int] = None):
        """One super-batch over all members: packed tallies [2, G]
        (row 0 = wec, row 1 = bec).

        ``tables`` are the decoder's stacked per-member one-hot matrices,
        passed as a traced ARGUMENT: closing over them would embed ~G x
        E^2 matrix entries in the compiled program as literals."""
        cfg = self.cfg
        batch = batch or cfg.batch
        kc, kd = jax.random.split(jax.random.fold_in(key, i))
        x = jnp.full((self.G, batch, self.n_var), cfg.codeword, jnp.int32)
        y = self.mod.send(kc, x, param)
        if cfg.channel == "bec":
            x_hat, _ = self.dec.decode_tables(tables, y)
        else:
            x_hat, _ = self.dec.decode_tables(tables,
                                              self.mod.llr(y, param))
        errs = (x_hat != x.astype(x_hat.dtype)).sum(axis=-1)   # [G, B]
        # ONE packed [2, G] tally array = ONE device->host fetch per chunk
        # (see MonteCarloRunner._chunk_body).
        return jnp.stack([(errs > 0).sum(axis=-1),
                          errs.sum(axis=-1)]).astype(jnp.int32)

    def _build_sharded_chunk(self, mesh):
        local = self.cfg.batch // mesh.devices.size

        def per_device(key, i, param, tables):
            dev_key = jax.random.fold_in(key, jax.lax.axis_index("batch"))
            tallies = self._chunk_body(dev_key, i, param, tables,
                                       batch=local)
            return jax.lax.psum(tallies, "batch")

        sharded = jax.shard_map(
            per_device, mesh=mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=P(),
            check_vma=False)
        return jax.jit(sharded)

    # ------------------------------------------------------------------
    def run_param(self, param: float, key) -> list:
        cfg = self.cfg
        tot = 0
        wec = np.zeros(self.G, np.int64)
        bec = np.zeros(self.G, np.int64)
        t_start = t_log = time.time()
        t_warm = None
        tot_warm = 0

        def member_status(g) -> OrderedDict:
            wer = wec[g] / tot if tot else 0.0
            ber = bec[g] / (tot * self.n_var) if tot else 0.0
            vals = OrderedDict([("tot", int(tot)), ("wec", int(wec[g])),
                                ("wer", float(wer)), ("bec", int(bec[g])),
                                ("ber", float(ber))])
            if t_warm is not None and tot > tot_warm:
                wps = (tot - tot_warm) / (time.time() - t_warm)
            else:
                elapsed = time.time() - t_start
                wps = tot / elapsed if elapsed > 0 else 0.0
            # Aggregate device throughput: all members decode at once.
            vals["words_per_sec"] = float(wps * self.G)
            return vals

        def log_and_save():
            self.log.info(
                "TOT:%d (x%d members), WEC:[%d..%d], WER:[%.3g..%.3g]",
                tot, self.G, wec.min(), wec.max(),
                wec.min() / max(tot, 1), wec.max() / max(tot, 1))
            for g, saver in enumerate(self.savers):
                saver.add(param, member_status(g))

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

        from ldpc_decoders_tpu.harness.runner import _start_host_copy

        chunk_i = 0
        while (wec < cfg.min_wec).any():
            chunk_i += 1
            pending.append(_start_host_copy(
                self._chunk(key, chunk_i, param, self.dec.tables)))
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
        return [member_status(g) for g in range(self.G)]

    def run(self) -> dict:
        """Full sweep. Returns {member_name: {param: metrics}}."""
        key = jax.random.PRNGKey(self.cfg.seed)
        results = {name: {} for name in self.member_names}
        for param in self.cfg.params:
            self.log.info("Starting parameter: %f (G=%d members)",
                          param, self.G)
            key, sub = jax.random.split(key)
            stats = self.run_param(param, sub)
            for name, st in zip(self.member_names, stats):
                results[name][param] = st
        self.log.info("Done!")
        return results


def ensemble_configs(cfg: RunConfig, member_names: Sequence[str]):
    """The per-member RunConfigs an EnsembleMonteCarloRunner replaces
    (for --emit parity with the reference's per-job command lines)."""
    return [dataclasses.replace(cfg, code=name) for name in member_names]
