"""Adaptive Monte-Carlo sweep runner.

Batched re-design of the reference's experiment harness (src/main.py:10-51).
The reference draws ONE codeword per loop iteration through un-compiled
numpy; here each host-loop tick runs a jit-compiled *super-batch chunk*
(sample -> transmit -> decode -> tally, all on device), and the reference's
adaptive ``while wec < min_wec`` termination (main.py:37) becomes a host
loop over chunks. The channel parameter is a traced scalar, so one
compilation serves every sweep point.

Multi-chip: pass a ``jax.sharding.Mesh`` with a ``batch`` axis; the chunk
is then ``shard_map``-ed so each device simulates ``batch/ndev`` codewords
and tallies combine with ``psum`` across devices — replacing the reference's
shell-level process fan-out + JSON-file merging (run_sims.sh:15-25,
SURVEY.md 2.23).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import OrderedDict
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ldpc_decoders_tpu.channels import CHANNELS
from ldpc_decoders_tpu.codes import get_code
from ldpc_decoders_tpu.harness.saver import Saver

ITER_HIST_LEN = 2000  # reference admm.py:36


def _start_host_copy(tallies):
    """Kick off the device->host copy of a chunk's packed tally vector at
    DISPATCH time (it enqueues behind the chunk's compute), so the
    blocking ``np.asarray`` in consume() lands pipeline-depth chunks
    later on already-transferred bytes. Host-side results (the LP
    route's numpy arrays) have no such method and pass through."""
    if hasattr(tallies, "copy_to_host_async"):
        tallies.copy_to_host_async()
    return tallies


@dataclasses.dataclass
class RunConfig:
    channel: str
    code: str
    decoder: str
    params: Sequence[float] = (0.1, 0.01)
    codeword: int = 0          # 0 / 1 / -1 = random codebook row
    min_wec: int = 100
    max_iter: int = 10
    mu: float = 3.0
    eps: float = 1e-5
    allow_pseudo: bool = False
    layers: Sequence[int] = (100, 100)
    train: bool = False
    apprx: int = -1
    iter_cap: int = 2000
    batch: int = 4096          # codewords per compiled chunk
    seed: int = 0
    log_freq: float = 5.0
    max_words: Optional[int] = None   # safety cap per sweep point (new)
    data_dir: Optional[str] = None
    cache_dir: Optional[str] = None
    profile: bool = False             # LoopProfiler per-section timings
    # BP message precision: "float32" (default, bit-matches the reference
    # regime) or "bfloat16" (half the message bytes; statistically
    # equivalent curves, validated vs goldens).
    msg_dtype: str = "float32"
    # Chunks dispatched ahead of the host sync point: overlaps host
    # tallying with device decode. 1 = fully synchronous.
    pipeline: int = 4
    # SPA inf handling: "reference" reproduces the float64 inf/NaN
    # cascade the golden curves depend on; "saturate" is the clean,
    # cheaper policy (decoders/bp.py, docs/PARITY.md).
    inf_policy: str = "reference"
    # Adaptive pipeline fill: ramp the dispatch pipeline up from depth 1
    # and cap in-flight chunks by the EXPECTED chunks remaining to
    # min_wec (err/chunk running estimate). Fast sweep points then stop
    # dispatching at the target instead of draining ``pipeline`` surplus
    # chunks (a fixed depth-4 x batch-16384 pipeline decodes up to 64k
    # words past the target at every easy point); deep tails see the
    # full pipeline unchanged. The stopping rule still depends only on
    # already-consumed tallies and every dispatched chunk is consumed,
    # so the min-wec estimator stays unbiased (reference main.py:37
    # semantics).
    adaptive_pipeline: bool = True
    def decoder_kwargs(self) -> dict:
        return dict(max_iter=self.max_iter, mu=self.mu, eps=self.eps,
                    allow_pseudo=self.allow_pseudo, layers=list(self.layers),
                    train=self.train, apprx=self.apprx,
                    iter_cap=self.iter_cap, cache_dir=self.cache_dir,
                    msg_dtype=jnp.dtype(self.msg_dtype),
                    inf_policy=self.inf_policy)


class MonteCarloRunner:
    """Runs one (channel, code, decoder) sweep to the target error count."""

    def __init__(self, cfg: RunConfig,
                 mesh: Optional[jax.sharding.Mesh] = None,
                 rotating: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.rotating = bool(rotating)
        self.mod = CHANNELS[cfg.channel]
        self.code = get_code(cfg.code)
        # A mesh with a "code" axis selects model parallelism: parity
        # checks shard over it (EdgeShardedBPDecoder) instead of — or,
        # 2-D, in addition to — the codeword batch. SURVEY.md section 5
        # "long-code edge sharding".
        self.code_sharded = (mesh is not None
                             and "code" in mesh.axis_names)
        if self.code_sharded:
            self.dec = self._build_edge_sharded(mesh)
        else:
            self.dec = self.mod.DECODERS[cfg.decoder](
                self.code, **cfg.decoder_kwargs())
        self.host_only = getattr(self.dec, "host_only", False)
        self.track_hist = getattr(getattr(self.dec, "dec", None),
                                  "track_iter_hist", False)
        # Stateful decoders (ADMMA online training) update host-side
        # parameters in decode(); tracing that inside the chunk jit would
        # leak tracers and silently discard the training, so their chunks
        # dispatch eagerly (the decoder's own inner jit still compiles
        # the hot loop).
        self.stateful = getattr(getattr(self.dec, "dec", None),
                                "stateful", False)
        # Tables-parameterized decoders (BP families) can take their
        # member-specific index/permutation tables as traced ARGUMENTS
        # instead of jit-baked constants: the compiled chunk then serves
        # any same-shape ensemble member (rotate_member). Engaged only
        # when ``rotating`` is requested — a plain single-code run keeps
        # the tables as jit-baked constants, which XLA can specialize.
        self.rotatable = (self.rotating
                          and hasattr(getattr(self.dec, "dec", None),
                                      "member_tables")
                          and not self.host_only and not self.stateful)
        if self.rotating and not self.rotatable:
            raise ValueError(
                f"decoder {cfg.decoder} does not support member rotation")

        # Run identity: same id-key convention as reference main.py:13.
        id_keys = (["channel", "code", "decoder", "codeword", "min_wec"]
                   + list(self.dec.id_keys or []))
        cfg_vars = dataclasses.asdict(cfg)
        self.id_vals = [cfg_vars[k] for k in id_keys]
        self.id_keys = id_keys
        self.log = logging.getLogger(".".join(str(v) for v in self.id_vals))
        # Multi-host: tallies are globally psum-reduced, so every process
        # sees identical results — host 0 is the single Saver writer
        # (replaces the reference's per-Slurm-task JSON files merged on a
        # shared filesystem, run_sims.sh:15-25).
        self.saver = (Saver(cfg.data_dir, list(zip(id_keys, self.id_vals)))
                      if cfg.data_dir and jax.process_index() == 0 else None)

        batch_span = (mesh.shape.get("batch", 1) if mesh is not None
                      else 1)
        if cfg.batch % batch_span:
            raise ValueError("batch must divide evenly over the mesh's "
                             "batch axis")
        if self.stateful and mesh is not None:
            # Functional state threading: replicated params ride the
            # chunk as an argument; grads pmean inside the decoder
            # keep every device's copy identical (synchronous
            # data-parallel training over the global batch).
            self._dec_state = self.dec.dec.get_state()
        self._edge_pad = 0
        self._build_chunk()

    # ------------------------------------------------------------------
    def _build_edge_sharded(self, mesh):
        """Model-parallel decoder for a "code"-axis mesh: checks (and
        message memory) shard over the axis, so codes too large for one
        chip Monte-Carlo end-to-end through the normal harness loop."""
        from ldpc_decoders_tpu.parallel.bp_edge_sharded import (
            EdgeShardedBPDecoder,
        )

        cfg = self.cfg
        if cfg.decoder not in ("SPA", "MSA"):
            raise ValueError("code-axis sharding supports the LLR-domain "
                             "BP decoders (SPA/MSA) only")
        if cfg.channel == "bec":
            raise ValueError("code-axis sharding is LLR-domain; the "
                             "ternary BEC SPA does not shard yet")
        batch_axis = "batch" if "batch" in mesh.axis_names else None
        inner = EdgeShardedBPDecoder(
            self.code.parity_mtx, mesh, cfg.decoder,
            max_iter=cfg.max_iter, iter_cap=cfg.iter_cap,
            batch_axis=batch_axis, inf_policy=cfg.inf_policy,
            check_init=(cfg.channel != "biawgn"))
        if cfg.channel == "biawgn":
            from ldpc_decoders_tpu.channels.biawgn import _AWGNLLRWrapped
            return _AWGNLLRWrapped(inner)
        from ldpc_decoders_tpu.channels.bsc import _LLRWrapped
        return _LLRWrapped(inner)

    # ------------------------------------------------------------------
    def _build_chunk(self) -> None:
        if self.mesh is not None and not self.code_sharded:
            self._chunk = self._build_sharded_chunk(self.mesh)
        elif self.stateful:
            self._chunk = self._chunk_body  # eager; decoder jits inside
        else:
            # A code-axis mesh needs no shard_map here: the edge-sharded
            # decoder IS the shard_map (tables sharded over the "code"
            # axis, one psum per BP iteration); sampling and tallies stay
            # replicated in a plain jit around it.
            self._chunk = jax.jit(self._chunk_body)

    # ------------------------------------------------------------------
    def rotate_member(self, code_name: str, n_edge_pad: int = 0,
                      seed: Optional[int] = None) -> None:
        """Point this runner at another same-shape ensemble member
        WITHOUT recompiling: the chunk executable reads all member-
        specific data from its traced ``tables`` argument, so swapping
        the inner decoder's tables (+ Saver/logger identity) re-targets
        the compiled program. This replaces the reference's
        10-cluster-jobs-per-ensemble-config pattern (simulations.py:79-85)
        — one compile, then every member decodes at single-code rate.

        ``n_edge_pad``: common edge-axis length for edge-layout decoders
        (BEC SPA) when members' double-edge cancellation left different
        edge counts. ``seed`` optionally re-seeds the member's sweep.
        """
        if not self.rotatable:
            raise ValueError("decoder does not support member rotation")
        if self.cfg.codeword == -1:
            raise ValueError("random-codeword mode samples a member-"
                             "specific codebook; rotation requires "
                             "codeword 0/1")
        self._edge_pad = int(n_edge_pad)
        self.cfg = dataclasses.replace(
            self.cfg, code=code_name,
            **({"seed": seed} if seed is not None else {}))
        self.code = get_code(code_name)
        inner = self.dec.dec
        inner.tables = inner.member_tables(self.code.graph,
                                           n_edge_pad=n_edge_pad)
        inner.graph = self.code.graph
        cfg_vars = dataclasses.asdict(self.cfg)
        self.id_vals = [cfg_vars[k] for k in self.id_keys]
        self.log = logging.getLogger(
            ".".join(str(v) for v in self.id_vals))
        self.saver = (Saver(self.cfg.data_dir,
                            list(zip(self.id_keys, self.id_vals)))
                      if self.cfg.data_dir and jax.process_index() == 0
                      else None)

    # ------------------------------------------------------------------
    def _sample_x(self, key, batch: int) -> jnp.ndarray:
        n = self.code.get_n()
        if self.cfg.codeword == -1:
            cb = jnp.asarray(self.code.cb, jnp.int32)
            idx = jax.random.randint(key, (batch,), 0, cb.shape[0])
            return cb[idx]
        return jnp.full((batch, n), self.cfg.codeword, jnp.int32)

    def _chunk_body(self, key, i, param, tables=None,
                    batch: Optional[int] = None):
        """One super-batch: returns ONE packed int32 tally vector —
        ``[wec, bec]``, extended with the in-graph iteration histogram
        (length ITER_HIST_LEN) for stats-tracking decoders. ``i`` is the
        chunk counter — key derivation happens inside jit so each chunk
        is a single host->device dispatch. ``tables`` (rotatable
        decoders) carries the member-specific decoder tables as traced
        arguments. One packed vector = one blocking device->host fetch
        per chunk, which the dispatch pipeline hides."""
        batch = batch or self.cfg.batch
        kx, kc, kd = jax.random.split(jax.random.fold_in(key, i), 3)
        x = self._sample_x(kx, batch)
        y = self.mod.send(kc, x, param)
        if tables is not None:
            x_hat, aux = self.dec.decode_tables(tables, y, param, kd)
        else:
            x_hat, aux = self.dec.decode(y, param, kd)
        errs = (x_hat != x.astype(x_hat.dtype)).sum(axis=-1)
        out = jnp.stack([(errs > 0).sum(), errs.sum()]).astype(jnp.int32)
        if self.track_hist:
            iters = aux.get("iters", jnp.zeros(batch, jnp.int32))
            hist = jnp.bincount(jnp.clip(iters, 0, ITER_HIST_LEN - 1),
                                length=ITER_HIST_LEN).astype(jnp.int32)
            out = jnp.concatenate([out, hist])
        return out

    def _build_sharded_chunk(self, mesh):
        local = self.cfg.batch // mesh.devices.size
        stateful = self.stateful
        rotatable = self.rotatable

        def per_device(key, i, param, *extra):
            dev_key = jax.random.fold_in(key, jax.lax.axis_index("batch"))
            tables = extra[0] if rotatable else None
            state = extra[1:] if rotatable else extra
            if stateful:
                self.dec.dec.begin_pure(state[0], axis_name="batch")
            tallies = self._chunk_body(dev_key, i, param,
                                       tables=tables, batch=local)
            # One psum covers wec, bec AND the in-graph histogram (the
            # packed tally vector is elementwise-additive across devices);
            # the replicated result is addressable on every host.
            summed = jax.lax.psum(tallies, "batch")
            if stateful:
                return summed, self.dec.dec.end_pure()
            return summed

        # Replicated extras: member tables (rotatable) and/or decoder
        # state (stateful); P() broadcasts over every pytree leaf.
        extra_specs = ((P(),) if rotatable else ()) + \
                      ((P(),) if stateful else ())
        # check_vma=False: decode loops carry constants (iteration counters)
        # that jax's varying-axis checker would otherwise reject; every
        # cross-device value we consume is explicitly psum-reduced.
        sharded = jax.shard_map(
            per_device, mesh=mesh,
            in_specs=(P(), P(), P()) + extra_specs,
            out_specs=(P(), P()) if stateful else P(),
            check_vma=False)
        return jax.jit(sharded)

    # ------------------------------------------------------------------
    def run_param(self, param: float, key) -> OrderedDict:
        cfg = self.cfg
        self._param = param
        param_key = key
        self._param_key = key
        tot = wec = bec = 0
        hist = np.zeros(ITER_HIST_LEN, dtype=np.int64)
        t_start = t_log = time.time()
        # Throughput is measured from after the first chunk lands (jit
        # compile + warmup excluded); counting compile time misreported
        # the first sweep point's words_per_sec by orders of magnitude.
        t_warm = None
        tot_warm = 0

        def status() -> OrderedDict:
            wer = wec / tot if tot else 0.0
            ber = bec / (tot * self.code.get_n()) if tot else 0.0
            vals = OrderedDict([("tot", int(tot)), ("wec", int(wec)),
                                ("wer", float(wer)), ("bec", int(bec)),
                                ("ber", float(ber))])
            if self.track_hist and hist.sum():
                avg = float(hist @ np.arange(ITER_HIST_LEN) / hist.sum())
                vals["dec"] = {"average": avg, "iter": hist.tolist()}
            if t_warm is not None and tot > tot_warm:
                wps = (tot - tot_warm) / (time.time() - t_warm)
            else:
                elapsed = time.time() - t_start
                wps = tot / elapsed if elapsed > 0 else 0.0
            vals["words_per_sec"] = float(wps)
            return vals

        def log_status():
            v = status()
            self.log.info(", ".join(
                f"{k.upper()}:{v[k]}" for k in
                ("tot", "wec", "wer", "bec", "ber", "words_per_sec")))
            if self.saver:
                self.saver.add(param, v)

        if self.host_only:
            decode_chunk = self._host_chunk
        elif self.stateful and self.mesh is not None:
            # Thread the replicated decoder state chunk-to-chunk; the
            # dependency chains dispatches but they stay asynchronous.
            def decode_chunk(i):
                t, self._dec_state = self._chunk(
                    param_key, i, param, self._dec_state)
                return _start_host_copy(t)
        elif self.rotatable:
            # Member tables ride every dispatch as traced arguments, so
            # rotate_member() swaps the decoded code without recompiling.
            def decode_chunk(i):
                return _start_host_copy(
                    self._chunk(param_key, i, param, self.dec.tables))
        else:
            # Returns a device array: dispatch is asynchronous, the sync
            # happens in consume() pipeline-depth slots later.
            def decode_chunk(i):
                return _start_host_copy(self._chunk(param_key, i, param))

        from collections import deque

        from ldpc_decoders_tpu.utils.profiler import LoopProfiler
        prof = LoopProfiler(self.log, dump_freq=20 if cfg.profile else 0)
        depth = max(1, int(cfg.pipeline)) if not self.host_only else 1
        pending: deque = deque()

        consumed = 0

        def consume():
            # ONE blocking fetch per chunk: the packed tally vector (see
            # _chunk_body). Its host copy was started at dispatch time, so
            # in steady state np.asarray finds the bytes already landed.
            nonlocal tot, wec, bec, hist, t_warm, tot_warm, consumed
            consumed += 1
            arr = np.asarray(pending.popleft(), dtype=np.int64)
            wec += int(arr[0])
            bec += int(arr[1])
            tot += cfg.batch
            if t_warm is None:
                t_warm = time.time()
                tot_warm = tot
            if self.track_hist:
                hist += arr[2:]

        def effective_depth(tick: int) -> int:
            """Pipeline-fill target for this tick (adaptive_pipeline).

            Two caps on cfg.pipeline: a 1-2-4-... ramp (one early sync,
            so a point the first chunk already finishes never builds a
            surplus pipeline), and — once errors have been observed —
            the expected number of chunks remaining to min_wec, so
            dispatch stops when the words already in flight are
            expected to cross the target."""
            if not cfg.adaptive_pipeline:
                return depth
            eff = min(depth, 1 << min(tick - 1, 10))
            if wec > 0 and consumed > 0 and wec < cfg.min_wec:
                exp_remaining = (cfg.min_wec - wec) * consumed / wec
                eff = min(eff, max(1, int(np.ceil(exp_remaining))))
            return eff

        chunk_i = 0
        while wec < cfg.min_wec:
            with prof.start():
                chunk_i += 1
                with prof.tag("dispatch"):
                    pending.append(decode_chunk(chunk_i))
                while len(pending) >= effective_depth(chunk_i):
                    with prof.tag("consume"):
                        consume()
                if time.time() - t_log > cfg.log_freq:
                    t_log = time.time()
                    with prof.tag("log"):
                        log_status()
            if cfg.max_words and tot + cfg.batch * len(pending) >= cfg.max_words:
                self.log.warning("max_words cap hit at %d", tot)
                break
        # Drain in-flight chunks; their inclusion is outcome-independent,
        # so the estimator stays unbiased (chunked min-wec semantics,
        # reference main.py:37 samples until the target is crossed).
        while pending:
            consume()
        # Dispatch accounting for tests/diagnostics: with
        # adaptive_pipeline every dispatched chunk is consumed and easy
        # points stop at (or near) the minimal chunk count.
        self.last_dispatch_stats = {"dispatched": chunk_i,
                                    "consumed": consumed}

        if self.stateful and self.mesh is not None:
            # Land the trained (replicated) params back on the decoder so
            # save()/later sweep points see them.
            self.dec.dec.set_state(self._dec_state)

        log_status()
        return status()

    def _host_chunk(self, i):
        """Host-side decoders (LP): sample on device, decode on host.
        Returns the same packed [wec, bec] tally vector as the device
        chunks so consume() is route-oblivious."""
        param = self._param
        kx, kc, kd = jax.random.split(
            jax.random.fold_in(self._param_key, i), 3)
        x = np.asarray(self._sample_x(kx, self.cfg.batch))
        y = self.mod.send(kc, jnp.asarray(x), param)
        x_hat, _ = self.dec.decode(y, param, kd)
        errs = (np.asarray(x_hat) != x.astype(np.asarray(x_hat).dtype)).sum(-1)
        return np.array([(errs > 0).sum(), errs.sum()], np.int64)

    def run(self) -> dict:
        """Full sweep (reference main.py:22-50). Returns {param: metrics}."""
        key = jax.random.PRNGKey(self.cfg.seed)
        results = {}
        for param in self.cfg.params:
            self.log.info("Starting parameter: %f", param)
            self._param = param
            key, sub = jax.random.split(key)
            results[param] = self.run_param(param, sub)
        self.log.info("Done!")
        return results


def run_rotating_members(cfg: RunConfig, member_names, mesh=None) -> dict:
    """Monte-Carlo a whole same-shape code ensemble, one member at a
    time, through ONE compiled chunk (see
    :meth:`MonteCarloRunner.rotate_member`). Per-member adaptive
    ``min_wec`` termination and per-member result files exactly as the
    reference's independent ensemble jobs produce
    (simulations.py:79-85). Returns ``{member: {param: metrics}}``."""
    e_pad = max(get_code(n).graph.n_edge for n in member_names)
    runner = MonteCarloRunner(
        dataclasses.replace(cfg, code=member_names[0]), mesh=mesh,
        rotating=True)
    results = {}
    for idx, name in enumerate(member_names):
        # Distinct seeds keep members' channel noise independent.
        runner.rotate_member(name, n_edge_pad=e_pad,
                             seed=cfg.seed + idx)
        results[name] = runner.run()
    return results
