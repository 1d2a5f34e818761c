"""LT fountain codes: robust-soliton sampling + batched incremental
peeling simulation.

Capability parity with reference src/luby.py, which measures how many
received symbols an LT code needs before the peeling (ripple) decoder
succeeds (MacKay Fig 50.4; reference README.md:65-68).

Batched re-design, two inversions of the reference:

1. The reference re-runs the peeling decoder from scratch for every
   prefix length num_sym = k..n (luby.py:52-68) — O(n) restarts. Peeling
   is *confluent* (the residual fixpoint is unique regardless of removal
   order), so the minimal successful prefix can be found with ONE
   incremental process: peel to a fixpoint, and only when stuck activate
   the next symbol. This is both the physical fountain process and
   decidedly cheaper.
2. The reference fans sims out over a multiprocessing.Pool
   (luby.py:153-180) one graph at a time through scipy CSC surgery; here
   a whole batch of sims runs in segmented ``lax.while_loop`` calls over
   padded edge tables ([B, E] static shapes, per-sim done masks). The
   peeling primitives are scatter-free: edges are stored sorted by
   symbol (plus a precomputed variable-order permutation), so every
   per-symbol / per-variable reduction is a cumsum + two indptr gathers.
   Degrees are soliton-distributed (a heavy spike near k/R), so the
   fixed-width gather layout used for LDPC graphs would waste 100x
   memory here — sorted-segment reductions fit this graph family.

Two interchangeable peel engines (bit-identical results, tested):

- ``engine="sparse"``: the [B, E] sorted-edge formulation above (native
  indexed loads) — what the committed golden artifacts were generated
  with.
- ``engine="dense"``: stores each sim's generator as a dense 0/1 int8
  matrix G [n, k] and reformulates every per-symbol / per-variable
  reduction as a batched matmul — NO dynamic gathers anywhere. Per peel
  round: one [B, 2, n] x [B, n, k] contraction (carrier count + carried
  bit per variable) and one [B, n, k] x [B, k, 2] contraction (xor
  contribution + incremental degree update per symbol); int8 x int8 ->
  int32 keeps every count exact. A golden-scale sim is only ~700 peel
  rounds, each reading G (~120 MB/sim) twice. Only the raw edge lists
  ship from the host (~1 MB/sim); G's bit-planes build on device (one
  scatter-add). Stuck-prefix jumps fuse into the same round's
  resolution, so every round resolves at least one variable or
  terminates.

``engine="auto"`` is the sparse engine: on the H100 at golden scale it
peeled 8 sims in 0.20 s against the dense engine's 0.85 s (PERF.md
"Bring-up on the H100"), and it is the native shape on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


# ----------------------------------------------------------------------
# Degree distributions (reference luby.py:91-126)
# ----------------------------------------------------------------------

def ideal_soliton(k: int) -> np.ndarray:
    """rho(1) = 1/k, rho(d) = 1/(d(d-1)) for d = 2..k."""
    rho = np.zeros(k)
    rho[0] = 1.0 / k
    d = np.arange(2, k + 1)
    rho[d - 1] = 1.0 / (d * (d - 1.0))
    return rho


def robust_tau(k: int, c: float, delta: float) -> np.ndarray:
    """The robust-soliton boost term with its spike at ceil(k/R),
    R = c*sqrt(k)*ln(k/delta) (reference luby.py:99-106)."""
    tau = np.zeros(k)
    R = c * np.sqrt(k) * np.log(k / delta)
    spike = int(np.ceil(k / R))
    d = np.arange(1, spike - 1 + 1)
    tau[d - 1] = R / (k * d)
    tau[spike - 1] = np.log(R / delta) * R / k
    return tau


def robust_soliton_parts(k: int, c: float, delta: float) -> tuple:
    """(rho, tau, normalized mu) — the decomposition the reference's
    soliton bar plot renders (luby.py:117-126, luby_graph.py:34-48)."""
    rho = ideal_soliton(k)
    tau = robust_tau(k, c, delta)
    mu = rho + tau
    return rho, tau, mu / mu.sum()


def robust_soliton(k: int, c: float, delta: float) -> np.ndarray:
    """Normalized rho + tau with spike at ceil(k/R), R = c*sqrt(k)*ln(k/d)."""
    return robust_soliton_parts(k, c, delta)[2]


# ----------------------------------------------------------------------
# Generator sampling (host): distinct column supports, soliton weights
# ----------------------------------------------------------------------

def sample_edges(rng: np.random.Generator, omega: np.ndarray, k: int, n: int,
                 e_pad: int, light: bool = False):
    """One sim's edge tables, in the segment-friendly sorted form.

    Column j gets weight w_j ~ omega and a uniformly random w_j-subset of
    the k message bits (reference luby.py:11-26 builds this by shuffling
    dense exact-weight columns; sampling supports directly is equivalent
    and O(sum w) instead of O(k*n)).

    Returns a dict of per-sim arrays:
    - edge_sym [E_pad] int32, NON-DECREASING (edges emitted column by
      column); pads use symbol n;
    - edge_var [E_pad] int32 (pads use variable k);
    - indptr_sym [n+2] int32: edge range of each symbol (pads in seg n);
    - perm_var [E_pad] int32: permutation putting edges in variable order;
    - indptr_var [k+2] int32: range of each variable in that order.
    The sorted form lets every segmented reduction on device be a
    cumsum + two indptr gathers instead of a scatter-add.
    """
    weights = rng.choice(np.arange(1, k + 1), size=n, p=omega)
    total = int(weights.sum())
    if total > e_pad:
        raise ValueError(f"edge budget {e_pad} < sampled {total}; "
                         "raise e_pad")
    sym = np.repeat(np.arange(n, dtype=np.int32), weights)
    var = np.empty(total, dtype=np.int32)
    pos = 0
    for w in weights:
        var[pos:pos + w] = rng.choice(k, size=w, replace=False)
        pos += w
    edge_sym = np.full(e_pad, n, dtype=np.int32)
    edge_var = np.full(e_pad, k, dtype=np.int32)
    edge_sym[:total] = sym
    edge_var[:total] = var
    if light:
        # Dense-engine callers need only the raw edge lists (the RNG
        # draws above are identical either way — the sorted-layout
        # post-processing below is deterministic).
        return dict(edge_sym=edge_sym, edge_var=edge_var)

    indptr_sym = np.zeros(n + 2, dtype=np.int32)
    np.cumsum(np.bincount(edge_sym, minlength=n + 1), out=indptr_sym[1:])
    perm_var = np.argsort(edge_var, kind="stable").astype(np.int32)
    indptr_var = np.zeros(k + 2, dtype=np.int32)
    np.cumsum(np.bincount(edge_var, minlength=k + 1), out=indptr_var[1:])
    return dict(edge_sym=edge_sym, edge_var=edge_var,
                indptr_sym=indptr_sym, perm_var=perm_var,
                indptr_var=indptr_var)


def default_e_pad(omega: np.ndarray, n: int) -> int:
    d = np.arange(1, omega.size + 1)
    mean = float(omega @ d)
    var = float(omega @ (d - mean) ** 2)
    return int(n * mean + 8.0 * np.sqrt(n * var) + 64)


# ----------------------------------------------------------------------
# Batched incremental peeling under jit
# ----------------------------------------------------------------------

class _State(NamedTuple):
    resolved: jnp.ndarray  # [B, k] bool
    unres_e: jnp.ndarray   # [B, E] bool: valid edge, variable unresolved
    est: jnp.ndarray       # [B, k] int32 recovered bits
    rcv: jnp.ndarray       # [B, n] int32 current symbol values
    m: jnp.ndarray         # [B] int32 active prefix length
    done: jnp.ndarray      # [B] bool
    result: jnp.ndarray    # [B] int32 symbols needed (n on failure)
    it: jnp.ndarray        # scalar int32


class _DenseState(NamedTuple):
    resolved: jnp.ndarray  # [B, k] bool
    deg: jnp.ndarray       # [B, n] int32: per-symbol unresolved degree
    est: jnp.ndarray       # [B, k] int32 recovered bits
    rcv: jnp.ndarray       # [B, n] int32 current symbol values
    m: jnp.ndarray         # [B] int32 active prefix length
    done: jnp.ndarray      # [B] bool
    result: jnp.ndarray    # [B] int32 symbols needed (n on failure)
    it: jnp.ndarray        # scalar int32


def _take_pad(arr: jnp.ndarray, idx: jnp.ndarray, fill) -> jnp.ndarray:
    """Batched gather where index == arr.shape[-1] selects `fill`."""
    pad = jnp.full(arr.shape[:-1] + (1,), fill, arr.dtype)
    return jnp.take_along_axis(jnp.concatenate([arr, pad], -1), idx, axis=-1)


@dataclasses.dataclass
class LTSimulator:
    """Batched LT simulation: minimal number of received symbols for a
    successful peeling decode, per sim.

    The device decode runs in bounded segments (``seg_iters`` loop
    iterations per jit call, host checks completion between calls): a
    batch stops at the segment boundary after its last sim finishes, and
    no single device execution runs for the whole decode."""

    k: int
    n: int
    c: float
    delta: float
    e_pad: Optional[int] = None
    # Loop iterations per device call for the sparse engine; the dense
    # engine's rounds each resolve more, and it runs 4x as many per call.
    seg_iters: int = 64
    # "sparse" ([B, E] sorted-edge cumsum/gather peel), "dense" (per-sim
    # 0/1 int8 G, peel rounds = batched int8 matmuls), or "auto"
    # (= sparse, see the module docstring). Both produce bit-identical (result, est, resolved)
    # — pinned by tests/test_lt.py::test_dense_engine_matches_sparse.
    engine: str = "auto"

    def __post_init__(self):
        self.omega = robust_soliton(self.k, self.c, self.delta)
        if self.e_pad is None:
            self.e_pad = default_e_pad(self.omega, self.n)
        if self.engine == "auto":
            self.engine = "sparse"
        if self.engine not in ("sparse", "dense"):
            raise ValueError(f"unknown LT engine {self.engine!r}")
        self._init = jax.jit(self._init_state)
        self._seg = jax.jit(self._segment)
        self._init_d = jax.jit(self._init_dense)
        self._seg_d = jax.jit(self._segment_dense)

    # -- host sampling --------------------------------------------------
    def sample_batch(self, rng: np.random.Generator, batch: int):
        # The dense engine ships ONLY the raw edge lists (~1 MB/sim at
        # golden scale) and builds the bit-planes of G on device, instead
        # of a host-packed G (15 MB/sim) or the sparse layout tables
        # (~1.7 MB/sim of perm/indptr).
        light = self.engine == "dense"
        tables = [sample_edges(rng, self.omega, self.k, self.n,
                               self.e_pad, light=light)
                  for _ in range(batch)]
        batched = {key: jnp.asarray(np.stack([t[key] for t in tables]))
                   for key in tables[0]}
        batched["msg"] = jnp.asarray(
            rng.integers(0, 2, size=(batch, self.k)).astype(np.int32))
        return batched

    # -- segmented reductions (sorted edges: cumsum + indptr gathers) ----
    def _seg_sum_sym(self, tables, data: jnp.ndarray) -> jnp.ndarray:
        """[B, E] -> [B, n] per-symbol sums (pads land in segment n)."""
        c = jnp.cumsum(data.astype(jnp.int32), axis=-1)
        c = jnp.concatenate([jnp.zeros_like(c[:, :1]), c], -1)   # [B, E+1]
        ip = tables["indptr_sym"]
        return (jnp.take_along_axis(c, ip[:, 1:], -1)
                - jnp.take_along_axis(c, ip[:, :-1], -1))[:, :self.n]

    def _seg_sum_var(self, tables, data_sym_order: jnp.ndarray) -> jnp.ndarray:
        """[B, E] (symbol order) -> [B, k] per-variable sums."""
        d = jnp.take_along_axis(data_sym_order, tables["perm_var"], -1)
        c = jnp.cumsum(d.astype(jnp.int32), axis=-1)
        c = jnp.concatenate([jnp.zeros_like(c[:, :1]), c], -1)
        ip = tables["indptr_var"]
        return (jnp.take_along_axis(c, ip[:, 1:], -1)
                - jnp.take_along_axis(c, ip[:, :-1], -1))[:, :self.k]

    # -- device decode ---------------------------------------------------
    def _init_state(self, tables) -> _State:
        k, n = self.k, self.n
        B = tables["msg"].shape[0]
        bits_e = _take_pad(tables["msg"], tables["edge_var"], 0)
        snt = (self._seg_sum_sym(tables, bits_e) % 2).astype(jnp.int32)
        return _State(
            resolved=jnp.zeros((B, k), bool),
            unres_e=tables["edge_sym"] < self.n,
            est=jnp.zeros((B, k), jnp.int32),
            rcv=snt,
            m=jnp.full((B,), k, jnp.int32),
            done=jnp.zeros((B,), bool),
            result=jnp.full((B,), n, jnp.int32),
            it=jnp.zeros((), jnp.int32),
        )

    def _segment(self, tables, s0: _State) -> _State:
        k, n = self.k, self.n
        edge_sym, edge_var = tables["edge_sym"], tables["edge_var"]
        valid = edge_sym < n
        sym_idx = jnp.arange(n, dtype=jnp.int32)

        def body(s: _State):
            # The [B, E] gathers dominate the cost, so the loop carries
            # the unresolved-edge mask in state (one gather saved) and
            # every remaining gather pulls a PACKED value (flag and bit
            # in one int) — 3 edge-sized gathers per iteration instead
            # of the naive formulation's 7.
            unresolved_e = s.unres_e                              # [B, E]
            edge_active = unresolved_e & (edge_sym < s.m[:, None])

            # Success first: a fixpoint with no active edges decodes at m.
            success = ~edge_active.any(-1)

            # Degrees over ALL symbols (prefix and future): the prefix
            # part drives the ripple; the future part the stuck-jump.
            deg_all = self._seg_sum_sym(tables, unresolved_e)     # [B, n]
            ripple = (deg_all == 1) & (sym_idx < s.m[:, None])
            has_ripple = ripple.any(-1)

            # Resolve: each active edge whose symbol is in the ripple
            # carries that symbol's residual value to its variable. All
            # carriers of one variable carry the same (true) bit, so
            # count/sum replaces the reference's per-column scatter.
            # Packed gather: 0 = not ripple, else residual bit + 1.
            rip_val = jnp.where(ripple, s.rcv + 1, 0)             # [B, n]
            gath = _take_pad(rip_val, edge_sym, 0)                # [B, E]
            resolve_edge = edge_active & (gath > 0)
            val_e = jnp.where(resolve_edge, gath - 1, 0)
            # One var-order pass for (carrier count, carried bit sum):
            # cnt <= var degree < 2^15, so low/high int32 halves pack.
            packed = resolve_edge.astype(jnp.int32) + val_e * 32768
            sp = self._seg_sum_var(tables, packed)                # [B, k]
            cnt = sp % 32768
            val = sp // 32768
            newly = (cnt > 0) & ~s.resolved
            est = jnp.where(newly, (val > 0).astype(jnp.int32), s.est)
            resolved = s.resolved | newly

            # XOR each newly-resolved bit into EVERY symbol containing it
            # (also beyond the prefix: later symbols arrive pre-reduced).
            # Packed gather again: 0 = not newly, else bit + 1.
            new_val = jnp.where(newly, est + 1, 0)                # [B, k]
            g2 = _take_pad(new_val, edge_var, 0)                  # [B, E]
            contrib = self._seg_sum_sym(
                tables, jnp.where(unresolved_e & (g2 > 0), g2 - 1, 0))
            rcv = (s.rcv + contrib) % 2
            unres_e = unresolved_e & (g2 == 0)

            # No ripple and not successful: jump the prefix forward. A
            # stuck fixpoint cannot be cured by symbols of unresolved
            # degree != 1 (they only ADD active edges), so the minimal
            # successful prefix extends exactly to the first future symbol
            # with current degree 1 — activating the ones in between one
            # at a time (reference luby.py:52-70) provably yields the same
            # num_sym; the jump removes O(n-k) loop iterations. No such
            # symbol: failure with result = n (like the reference).
            grow = ~s.done & ~success & ~has_ripple
            nxt = jnp.min(jnp.where((deg_all == 1)
                                    & (sym_idx >= s.m[:, None]),
                                    sym_idx, n), axis=-1)         # [B]
            m = jnp.where(grow & (nxt < n), nxt + 1, s.m)
            fail = grow & (nxt >= n)

            act = ~s.done
            act2 = act[:, None]
            return _State(
                resolved=jnp.where(act2, resolved, s.resolved),
                unres_e=jnp.where(act2, unres_e, s.unres_e),
                est=jnp.where(act2, est, s.est),
                rcv=jnp.where(act2, rcv, s.rcv),
                m=jnp.where(act, m, s.m),
                done=s.done | (act & (success | fail)),
                result=jnp.where(act & success, s.m, s.result),
                it=s.it + 1,
            )

        def cond(s: _State):
            return (s.it < self.seg_iters) & ~s.done.all()

        final = lax.while_loop(cond, body, s0)
        return final._replace(it=jnp.zeros((), jnp.int32))

    # -- dense engine: peel rounds as batched int8 matmuls ----------------
    def _build_g(self, tables) -> jnp.ndarray:
        """Edge lists -> dense 0/1 int8 G [B, n, k], built on device:
        one scatter-add into bit-packed planes (pads target the sliced-
        off guard row/byte; supports are distinct so add == or) + a
        bit unpack."""
        k, n = self.k, self.n
        kb = (k + 7) // 8
        sym, var = tables["edge_sym"], tables["edge_var"]
        B = sym.shape[0]
        bidx = jnp.broadcast_to(
            jnp.arange(B, dtype=jnp.int32)[:, None], sym.shape)
        packed = jnp.zeros((B, n + 1, kb + 1), jnp.int32)
        packed = packed.at[bidx, sym, var >> 3].add(
            jnp.int32(1) << (var & 7), mode="drop")
        bits = (packed[:, :n, :kb, None] >> jnp.arange(8)) & 1
        return bits.reshape(B, n, kb * 8)[..., :k].astype(jnp.int8)

    def _init_dense(self, tables):
        k, n = self.k, self.n
        msg = tables["msg"]
        B = msg.shape[0]
        g = self._build_g(tables)                             # [B, n, k]
        # int8 x int8 -> int32: exact counts (degrees <= k,
        # carrier counts <= var degree — far inside int32).
        snt = lax.dot_general(
            g, msg.astype(jnp.int8)[..., None],
            (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)[..., 0] % 2      # [B, n]
        return g, _DenseState(
            resolved=jnp.zeros((B, k), bool),
            deg=g.astype(jnp.int32).sum(-1),                   # [B, n]
            est=jnp.zeros((B, k), jnp.int32),
            rcv=snt,
            m=jnp.full((B,), k, jnp.int32),
            done=jnp.zeros((B,), bool),
            result=jnp.full((B,), n, jnp.int32),
            it=jnp.zeros((), jnp.int32),
        )

    def _segment_dense(self, g: jnp.ndarray, s0: _DenseState) -> _DenseState:
        """Same peel/jump semantics as :meth:`_segment`, with every
        per-symbol / per-variable reduction a batched int8 matmul over
        the dense generator ``g`` [B, n, k] — gather-free, so each round
        costs two passes over g instead of the sparse engine's dynamic
        gathers.
        Bit-identical to the sparse engine by construction: ``deg`` is
        maintained incrementally (deg' = deg − G @ newly), and carrier
        count/carried bit per variable come from one stacked
        [ripple, ripple·rcv] contraction exactly like the sparse
        engine's packed low/high reduction."""
        n = self.n
        sym_idx = jnp.arange(n, dtype=jnp.int32)

        def body(s: _DenseState):
            prefix = sym_idx < s.m[:, None]                    # [B, n]
            # Success: a fixpoint with no unresolved edge in the prefix.
            success = ~((s.deg > 0) & prefix).any(-1)
            ripple = (s.deg == 1) & prefix
            has_ripple = ripple.any(-1)

            # Stuck fixpoint: extend the prefix to the first future
            # symbol of current degree 1 (same argument as the sparse
            # engine); none => failure with result = n. The jump FUSES
            # into this round's resolution (the new symbol IS the
            # ripple) — a separate jump round would burn a full 2-matmul
            # round resolving nothing, and overhead-heavy sims take
            # ~1000 consecutive jumps. Same confluent fixpoint, so
            # result/est/resolved are bit-identical to the sparse
            # engine's two-phase jumps (pinned by the equality test).
            grow = ~s.done & ~success & ~has_ripple
            nxt = jnp.min(jnp.where((s.deg == 1) & ~prefix, sym_idx, n),
                          axis=-1)                              # [B]
            can_jump = grow & (nxt < n)
            m = jnp.where(can_jump, nxt + 1, s.m)
            fail = grow & (nxt >= n)
            ripple = ripple | (can_jump[:, None]
                               & (sym_idx == nxt[:, None]))

            # Variable side: carriers = ripple symbols; every carrier of
            # a variable carries the same (true) residual bit, so one
            # stacked contraction yields (carrier count, carried bit sum).
            r2 = jnp.stack([ripple, ripple & (s.rcv > 0)],
                           1).astype(jnp.int8)                 # [B, 2, n]
            kv = lax.dot_general(r2, g, (((2,), (1,)), ((0,), (0,))),
                                 preferred_element_type=jnp.int32)
            unres = ~s.resolved
            cnt = jnp.where(unres, kv[:, 0], 0)                # [B, k]
            newly = cnt > 0
            est = jnp.where(newly, (kv[:, 1] > 0).astype(jnp.int32), s.est)
            resolved = s.resolved | newly

            # Symbol side: xor each newly-resolved bit into every symbol
            # containing it, and retire those edges from the degrees —
            # one stacked [newly, newly & est] contraction.
            n2 = jnp.stack([newly, newly & (est > 0)],
                           -1).astype(jnp.int8)                # [B, k, 2]
            sv = lax.dot_general(g, n2, (((2,), (1,)), ((0,), (0,))),
                                 preferred_element_type=jnp.int32)
            deg = s.deg - sv[..., 0]
            rcv = (s.rcv + sv[..., 1]) % 2

            act = ~s.done
            act2 = act[:, None]
            return _DenseState(
                resolved=jnp.where(act2, resolved, s.resolved),
                deg=jnp.where(act2, deg, s.deg),
                est=jnp.where(act2, est, s.est),
                rcv=jnp.where(act2, rcv, s.rcv),
                m=jnp.where(act, m, s.m),
                done=s.done | (act & (success | fail)),
                result=jnp.where(act & success, s.m, s.result),
                it=s.it + 1,
            )

        def cond(s: _DenseState):
            return (s.it < 4 * self.seg_iters) & ~s.done.all()

        final = lax.while_loop(cond, body, s0)
        return final._replace(it=jnp.zeros((), jnp.int32))

    # -- public API -------------------------------------------------------
    def shard_tables(self, tables, mesh):
        """Lay a sampled batch out over a ``batch``-axis mesh. Every
        per-sim quantity is independent (the reference's Pool fan-out,
        luby.py:175, as a mesh axis): all arrays shard on dim 0, so the
        jitted init/segment programs SPMD-partition with zero
        cross-device communication — sims run where their tables live.
        Exact equality with the unsharded run is pinned by
        tests/test_lt.py::test_dense_engine_sharded_matches_single."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = NamedSharding(mesh, P("batch"))
        return {k: jax.device_put(v, spec) for k, v in tables.items()}

    def simulate(self, tables) -> tuple:
        """Run sampled tables to completion. Returns (result, est,
        resolved) device arrays."""
        if self.engine == "dense":
            g, state = self._init_d(tables)
            max_segments = (self.k + self.n) // (4 * self.seg_iters) + 2
            for _ in range(max_segments):
                state = self._seg_d(g, state)
                if bool(state.done.all()):
                    break
            return state.result, state.est, state.resolved
        state = self._init(tables)
        # Each iteration peels a round (resolves >= 1 variable) or jumps
        # the prefix (activates >= 1 symbol), so k + n + 2 iterations
        # bound the process; segments keep each device call short.
        max_segments = (self.k + self.n) // self.seg_iters + 2
        for _ in range(max_segments):
            state = self._seg(tables, state)
            if bool(state.done.all()):
                break
        return state.result, state.est, state.resolved

    def run(self, rng: np.random.Generator, batch: int):
        """Returns (num_symbols [B], est [B,k], resolved [B,k])."""
        tables = self.sample_batch(rng, batch)
        res, est, resolved = self.simulate(tables)
        return np.asarray(res), np.asarray(est), np.asarray(resolved)


def stream_batches(sim: LTSimulator, rng: np.random.Generator,
                   count: int, batch: int, mesh=None):
    """Decode ``count`` sims in device batches, yielding each batch's
    num-symbols results (np array). Host graph sampling (~0.2 s/sim at
    golden scale) overlaps the device peel of the previous batch: one
    sampler thread stays exactly a batch ahead (rng is only ever touched
    from that thread and submissions are sequential, so the stream is
    deterministic). The batched re-expression of the reference's
    multiprocessing.Pool fan-out (luby.py:175); with ``mesh``, whole
    batches additionally shard over the mesh's ``batch`` axis
    (shard_tables). Shared by the CLI and the measurement scripts."""
    from concurrent.futures import ThreadPoolExecutor

    n_mesh = mesh.shape["batch"] if mesh is not None else 1
    ex = ThreadPoolExecutor(1)
    fut = ex.submit(sim.sample_batch, rng, min(batch, count))
    submitted = done = 0
    try:
        while done < count:
            tables = fut.result()
            b = int(tables["msg"].shape[0])
            submitted += b
            nxt = min(batch, count - submitted)
            if nxt > 0:
                fut = ex.submit(sim.sample_batch, rng, nxt)
            if mesh is not None and b % n_mesh == 0:
                tables = sim.shard_tables(tables, mesh)
            res, _, _ = sim.simulate(tables)
            done += b
            yield np.asarray(res)
    finally:
        ex.shutdown(wait=False)


# ----------------------------------------------------------------------
# CLI (reference luby.py:142-180): python -m ldpc_decoders_tpu.fountain.lt
# ----------------------------------------------------------------------

def main(argv=None):
    import argparse
    import logging

    from ldpc_decoders_tpu.harness.saver import Saver
    from ldpc_decoders_tpu.utils.file import resolve_data_dir_os

    p = argparse.ArgumentParser(description="LT fountain-code simulation")
    p.add_argument("k", type=int)
    p.add_argument("n", type=int)
    p.add_argument("c", type=float)
    p.add_argument("delta", type=float)
    p.add_argument("count", type=int)
    p.add_argument("--batch", type=int, default=64,
                   help="sims per compiled device batch "
                        "(replaces the reference --pool)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "sparse", "dense"],
                   help="peel engine: sparse = sorted-edge gathers, "
                        "dense = int8 matmul rounds; auto = sparse")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard each batch of sims over N devices "
                        "(batch-axis mesh; sims are independent, so "
                        "the program partitions with no collectives)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_dir",
                   default=resolve_data_dir_os("decoders") + "/data")
    p.add_argument("--console", action="store_true")
    args = p.parse_args(argv)

    logging.basicConfig(format="%(name)s|%(message)s", level=logging.INFO)
    id_keys = ["k", "n", "c", "delta"]
    id_val = [str(vars(args)[key]) for key in id_keys]
    saver = Saver(args.data_dir, list(zip(["type"] + id_keys,
                                          ["luby"] + id_val)))
    log = logging.getLogger(".".join(id_val))

    sim = LTSimulator(args.k, args.n, args.c, args.delta,
                      engine=args.engine)
    # Resume semantics: ``count`` is the TOTAL target — an existing
    # artifact's sims are kept and extended. The PRNG stream is seeded by
    # (seed, #existing) so resumed runs draw disjoint sims without the
    # caller having to manage seeds.
    from ldpc_decoders_tpu.utils.file import load_json
    existing = load_json(saver.file_path)
    arr = [int(v) for v in existing["arr"]] \
        if existing and "arr" in existing else []
    if arr:
        log.info("resuming from %d committed sims", len(arr))
    rng = np.random.default_rng([args.seed, len(arr)])
    mesh = None
    if args.mesh:
        from ldpc_decoders_tpu.parallel import batch_mesh
        mesh = batch_mesh(args.mesh)
    for res in stream_batches(sim, rng, args.count - len(arr),
                              args.batch, mesh=mesh):
        arr.extend(int(r) for r in res)
        log.info("sims=%d mean=%.1f std=%.1f", len(arr),
                 float(np.mean(arr)), float(np.std(arr)))
        saver.add_all({"arr": arr})
    log.info("Finished all!")


if __name__ == "__main__":
    main()
