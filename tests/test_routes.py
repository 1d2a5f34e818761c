"""The XLA data-movement routes against each other on full-width codes.

BP decodes through "incidence" (one-hot [E, V] dots), "matmul" (one-hot
E x E permutations) or "gather" (slot-map index gathers); ADMM through
"matmul" or "gather". In float32 at Precision.HIGHEST every route is an
exact 0/1 linear map, so they agree up to the summation order of the
per-variable marginal; bfloat16 messages round at different points of
the variable update. Both are held to the float-route bar
(ldpc_decoders_tpu/utils/compare.py); integer dynamics must agree bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_decoders_tpu.channels import bec, biawgn, bsc
from ldpc_decoders_tpu.codes import get_code
from ldpc_decoders_tpu.decoders.admm import ADMMDecoder
from ldpc_decoders_tpu.decoders.bec_spa import BECSPADecoder
from ldpc_decoders_tpu.decoders.bp import BPDecoder
from ldpc_decoders_tpu.utils.compare import mismatch_counts, within_float_bar
from tests.ref_semantics_oracle import decode_bec_ref

ALT_ROUTES = ["matmul", "gather"]


@pytest.fixture(scope="module")
def code():
    return get_code("1200_3_6_ldpc")


def _decode(dec, inp):
    x, it = jax.jit(dec.decode)(inp)
    return np.asarray(x), np.asarray(it)


def _assert_float_bar(a, b, n):
    dec, it = mismatch_counts(a[0], a[1], b[0], b[1])
    assert within_float_bar(dec, it, n), (dec, it, n)


def _biawgn_llr(code, B, seed, snr=3.0):
    xw = jnp.zeros((B, code.get_n()), jnp.int32)
    return biawgn.llr(biawgn.send(jax.random.PRNGKey(seed), xw, snr), snr)


def _bsc_llr(code, B, seed, p, codeword=0):
    xw = jnp.full((B, code.get_n()), codeword, jnp.int32)
    return bsc.llr(bsc.send(jax.random.PRNGKey(seed), xw, p), p)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("route", ALT_ROUTES)
def test_msa_routes_match_incidence(code, dtype, route):
    """biAWGN MSA at 3 dB: every route decodes like the incidence route
    (float32: bit-identical; bfloat16: within the float bar)."""
    B = 256
    llr = _biawgn_llr(code, B, 7)
    kw = dict(max_iter=10, msg_dtype=jnp.dtype(dtype), check_init=False)
    ref = _decode(BPDecoder(code.graph, "MSA", perm="incidence", **kw), llr)
    got = _decode(BPDecoder(code.graph, "MSA", perm=route, **kw), llr)
    if dtype == "float32":
        np.testing.assert_array_equal(ref[0], got[0])
        np.testing.assert_array_equal(ref[1], got[1])
    else:
        _assert_float_bar(ref, got, B)


@pytest.mark.parametrize("route", ["incidence"] + ALT_ROUTES)
def test_check_init_pre_exit(code, route):
    """Bit-input-style LLRs whose hard decision is already a codeword
    exit with zero iterations when check_init=True, on every route."""
    llr = jnp.full((64, code.get_n()), 4.0, jnp.float32)   # all-zero cw
    x, it = _decode(BPDecoder(code.graph, "MSA", max_iter=10, perm=route,
                              check_init=True), llr)
    assert (x == 0).all() and (it == 0).all()


@pytest.mark.parametrize("route", ALT_ROUTES)
def test_spa_saturate_routes_match_incidence(code, route):
    B = 256
    llr = _biawgn_llr(code, B, 11)
    kw = dict(max_iter=10, msg_dtype=jnp.bfloat16, check_init=False,
              inf_policy="saturate")
    ref = _decode(BPDecoder(code.graph, "SPA", perm="incidence", **kw), llr)
    got = _decode(BPDecoder(code.graph, "SPA", perm=route, **kw), llr)
    _assert_float_bar(ref, got, B)


@pytest.mark.parametrize("route", ALT_ROUTES)
def test_spa_refmode_routes_match_incidence_bsc(code, route):
    """Reference-inf-policy SPA at a low BSC crossover, where the inf/NaN
    cascade is active (the regime the policy exists for)."""
    B = 256
    llr = _bsc_llr(code, B, 5, 0.05)
    kw = dict(max_iter=30, msg_dtype=jnp.float32, inf_policy="reference")
    ref = _decode(BPDecoder(code.graph, "SPA", perm="incidence", **kw), llr)
    got = _decode(BPDecoder(code.graph, "SPA", perm=route, **kw), llr)
    _assert_float_bar(ref, got, B)


@pytest.mark.parametrize("p", [0.02, 0.06])
def test_bsc_f32_tie_structure_within_bar(code, p):
    """BSC MSA float32: LLRs are equal multiples of log((1-p)/p), so the
    marginal's summation order flips the odd exact tie between routes.
    That jitter stays within the float bar."""
    B = 256
    llr = _bsc_llr(code, B, int(p * 1000), p)
    kw = dict(max_iter=10, msg_dtype=jnp.float32, check_init=False)
    ref = _decode(BPDecoder(code.graph, "MSA", perm="incidence", **kw), llr)
    got = _decode(BPDecoder(code.graph, "MSA", perm="gather", **kw), llr)
    _assert_float_bar(ref, got, B)
    assert int(np.abs(ref[1] - got[1]).max()) <= 3


@pytest.mark.parametrize("variant", ["MSA", "SPA"])
def test_margulis_bp_gather_matches_incidence(variant):
    mar = get_code("margulis")
    B = 8
    llr = _bsc_llr(mar, B, 23, 0.05, codeword=1)
    kw = dict(max_iter=5, msg_dtype=jnp.float32)
    ref = _decode(BPDecoder(mar.graph, variant, perm="incidence", **kw), llr)
    got = _decode(BPDecoder(mar.graph, variant, perm="gather", **kw), llr)
    _assert_float_bar(ref, got, B)


def test_margulis_admm_matmul_matches_gather():
    mar = get_code("margulis")
    B = 16
    llr = _biawgn_llr(mar, B, 19)
    kw = dict(mu=3.0, eps=1e-5, max_iter=20)
    ref = _decode(ADMMDecoder(mar.graph, perm="gather", **kw), llr)
    got = _decode(ADMMDecoder(mar.graph, perm="matmul", **kw), llr)
    _assert_float_bar(ref, got, B)


@pytest.mark.parametrize("channel", ["biawgn", "bec"])
def test_admm_matmul_matches_gather(code, channel):
    """ADMM matmul (HIGHEST-precision one-hot dots) vs gather. The BEC
    case pins the convergence test's sensitivity: it compares
    ||x_e - z||^2 against eps^2 = 1e-10 per edge, so any lossy hop would
    shift iteration counts."""
    B = 64
    if channel == "biawgn":
        llr = _biawgn_llr(code, B, 13)
    else:
        xw = jnp.zeros((B, code.get_n()), jnp.int32)
        y = bec.send(jax.random.PRNGKey(41), xw, 0.35)
        # BEC LLR adapter: erasure -> 0, known -> +-1e8 (ref bec.py:41-42).
        llr = jnp.where(y == 2, 0.0, jnp.where(y == 0, 1e8, -1e8))
    kw = dict(mu=3.0, eps=1e-5, max_iter=30)
    ref = _decode(ADMMDecoder(code.graph, perm="gather", **kw), llr)
    got = _decode(ADMMDecoder(code.graph, perm="matmul", **kw), llr)
    _assert_float_bar(ref, got, B)


def test_bec_stopping_sets_match_oracle(code):
    """Above threshold the ternary decoder freezes words in stopping sets
    with erasures left (bec.py:120) — word-exact against the oracle."""
    B = 24
    xw = jnp.zeros((B, code.get_n()), jnp.int32)
    y = np.asarray(bec.send(jax.random.PRNGKey(9), xw, 0.45))
    x, _ = _decode(BECSPADecoder(code.graph, max_iter=200), jnp.asarray(y))
    assert (x == 2).any(), "expected surviving erasures"
    for b in range(B):
        np.testing.assert_array_equal(
            x[b], decode_bec_ref(code.parity_mtx, y[b], 200))


@pytest.mark.parametrize("make", [
    lambda g: BPDecoder(g, "MSA", perm="pallas"),
    lambda g: ADMMDecoder(g, perm="incidence"),
], ids=["bp", "admm"])
def test_unknown_route_rejected(code, make):
    with pytest.raises(ValueError, match="perm"):
        make(code.graph)
