"""Edge-sharded (model-parallel) BP vs the single-device decoder.

The check slices + one marginal psum per iteration must reproduce the
single-chip decoder's decisions: same algorithm, summation order differs
only in float addition grouping, so biAWGN (continuous LLRs, no ties)
decisions agree exactly with overwhelming probability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ldpc_decoders_tpu import get_code
from ldpc_decoders_tpu.channels import biawgn
from ldpc_decoders_tpu.decoders.bp import BPDecoder
from ldpc_decoders_tpu.parallel.bp_edge_sharded import EdgeShardedBPDecoder


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    assert len(devs) >= 8
    return Mesh(np.array(devs[:8]), ("code",))


@pytest.mark.parametrize("variant", ["SPA", "MSA"])
def test_matches_single_device(mesh, variant):
    code = get_code("1200_3_6_ldpc")
    key = jax.random.PRNGKey(11)
    x = jnp.zeros((64, code.get_n()), jnp.int32)
    y = biawgn.send(key, x, 1.5)
    llr = biawgn.llr(y, 1.5)

    sharded = EdgeShardedBPDecoder(code.parity_mtx, mesh, variant,
                                   max_iter=10, check_init=False)
    xs, its = sharded.decode(llr)
    ref = BPDecoder(code.graph, variant, max_iter=10, check_init=False)
    xr, itr = ref.decode(llr)

    xs, xr = np.asarray(xs), np.asarray(xr)
    # Identical trajectories up to float-sum grouping: allow at most a
    # couple of knife-edge words to differ, none in the common case.
    word_mismatch = (xs != xr).any(axis=1).sum()
    assert word_mismatch <= 1, f"{word_mismatch} words differ"
    if word_mismatch == 0:
        np.testing.assert_array_equal(np.asarray(its), np.asarray(itr))
    # Errors-per-word must agree as a statistic regardless.
    err_s = (xs != 0).sum()
    err_r = (xr != 0).sum()
    assert abs(err_s - err_r) <= max(5, 0.05 * max(err_s, err_r))


def test_uneven_check_split(mesh):
    """Hamming(7,4): 3 checks over 8 devices — empty and padded slices
    must be inert."""
    code = get_code("7_4_hamming")
    key = jax.random.PRNGKey(2)
    x = jnp.zeros((128, 7), jnp.int32)
    y = biawgn.send(key, x, 2.0)
    llr = biawgn.llr(y, 2.0)

    sharded = EdgeShardedBPDecoder(code.parity_mtx, mesh, "SPA",
                                   max_iter=10, check_init=False)
    xs, _ = sharded.decode(llr)
    xr, _ = BPDecoder(code.graph, "SPA", max_iter=10,
                      check_init=False).decode(llr)
    assert (np.asarray(xs) != np.asarray(xr)).any(axis=1).sum() <= 1


def test_harness_code_mesh_end_to_end(mesh):
    """A margulis Monte-Carlo through the harness with parity checks
    sharded over the 8-device "code" mesh: tallies must match the
    single-device run within combined MC error (same algorithm; float
    sum grouping differs)."""
    import math

    from ldpc_decoders_tpu.harness import MonteCarloRunner, RunConfig

    cfg = RunConfig(channel="biawgn", code="margulis", decoder="MSA",
                    params=[1.5], codeword=1, min_wec=25, batch=128,
                    max_iter=10, log_freq=1e9)
    res_sh = MonteCarloRunner(cfg, mesh=mesh).run()[1.5]
    res_one = MonteCarloRunner(cfg).run()[1.5]
    assert res_sh["tot"] >= 128
    se = math.sqrt(res_sh["wer"] / res_sh["tot"]
                   + res_one["wer"] / res_one["tot"])
    assert abs(res_sh["wer"] - res_one["wer"]) < 6 * se + 1e-9


def test_harness_code_mesh_2d(mesh):
    """4 x 2 batch x code mesh end-to-end: batch shards over one axis,
    checks over the other; statistics match the unsharded run."""
    import math

    from ldpc_decoders_tpu.harness import MonteCarloRunner, RunConfig
    from ldpc_decoders_tpu.parallel import code_mesh

    m2 = code_mesh(2, 4)
    assert dict(m2.shape) == {"batch": 4, "code": 2}
    cfg = RunConfig(channel="bsc", code="1200_3_6_ldpc", decoder="MSA",
                    params=[0.06], codeword=1, min_wec=25, batch=128,
                    max_iter=10, log_freq=1e9)
    res_sh = MonteCarloRunner(cfg, mesh=m2).run()[0.06]
    res_one = MonteCarloRunner(cfg).run()[0.06]
    se = math.sqrt(res_sh["wer"] / res_sh["tot"]
                   + res_one["wer"] / res_one["tot"])
    assert abs(res_sh["wer"] - res_one["wer"]) < 6 * se + 1e-9


def test_spa_reference_policy_matches_single_device(mesh):
    """Code-sharded refmode SPA (the sentinel inf/NaN cascade the golden
    curves depend on, bpa.py:35-62) vs the single-chip refmode decoder
    on margulis at a saturating operating point: the cascade classes are
    integer-exact across shards (counts psum exactly), so decisions may
    differ only on knife-edge finite sums (float grouping)."""
    code = get_code("margulis")
    key = jax.random.PRNGKey(5)
    from ldpc_decoders_tpu.channels import bsc
    x = jnp.zeros((32, code.get_n()), jnp.int32)
    y = bsc.send(key, x, 0.05)
    llr = bsc.llr(y, 0.05)

    sharded = EdgeShardedBPDecoder(code.parity_mtx, mesh, "SPA",
                                   max_iter=60)   # deep: cascade engages
    xs, its = sharded.decode(llr)
    assert sharded.inf_policy == "reference"      # BPDecoder's default
    ref = BPDecoder(code.graph, "SPA", max_iter=60)
    xr, itr = ref.decode(llr)
    xs, xr = np.asarray(xs), np.asarray(xr)
    word_ok = ~(xs != xr).any(axis=1)
    mismatch = int((~word_ok).sum())
    assert mismatch <= 1, f"{mismatch} words differ"
    # Iteration counts must agree on every MATCHING word even when one
    # knife-edge word differs — a systematic porting bug in the sharded
    # sentinel cascade would desynchronize counts across the whole batch,
    # not just the tied word.
    np.testing.assert_array_equal(np.asarray(its)[word_ok],
                                  np.asarray(itr)[word_ok])
    # The cascade must actually have fired somewhere at this depth
    # (poisoned words decide bit 0 = erased-to-zero behavior).
    assert (np.asarray(its) > 1).any()


def test_harness_code_mesh_spa_reference_policy(mesh):
    """Default inf_policy='reference' now runs code-sharded end-to-end:
    tallies match the single-device refmode run within MC error."""
    import math

    from ldpc_decoders_tpu.harness import MonteCarloRunner, RunConfig

    cfg = RunConfig(channel="bsc", code="1200_3_6_ldpc", decoder="SPA",
                    params=[0.06], codeword=0, min_wec=15, batch=64,
                    log_freq=1e9)
    res_sh = MonteCarloRunner(cfg, mesh=mesh).run()[0.06]
    res_one = MonteCarloRunner(cfg).run()[0.06]
    se = math.sqrt(res_sh["wer"] / res_sh["tot"]
                   + res_one["wer"] / res_one["tot"])
    assert abs(res_sh["wer"] - res_one["wer"]) < 6 * se + 1e-9


def test_code_mesh_validates_device_count():
    from ldpc_decoders_tpu.parallel import code_mesh
    with pytest.raises(ValueError, match="need"):
        code_mesh(64)
    with pytest.raises(ValueError, match="need"):
        code_mesh(8, 4)  # 32 devices on an 8-device host
    m = code_mesh(8)
    assert dict(m.shape) == {"code": 8}
