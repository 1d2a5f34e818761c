"""Oracle decode tests, porting the reference's inline smoke tests
(reference bec.py:128-163, bsc.py:78-129, biawgn.py:81-92 — the
"ML as exactness oracle" pattern, SURVEY.md section 4) to batched pytest.

Each case gives a hand-picked decodable (sent, received) pair; every
decoder must recover the sent word exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_decoders_tpu import codes
from ldpc_decoders_tpu.channels import CHANNELS
from ldpc_decoders_tpu.utils.compare import mismatch_counts, within_float_bar

KW = {"max_iter": 100}


def run_decoders(channel, code_name, param, decoder_names, x, y, **kw):
    """Decode y with each named decoder; return dict name -> est row."""
    mod = CHANNELS[channel]
    code = codes.get_code(code_name)
    x = np.asarray(x)
    y_batch = jnp.asarray(np.asarray(y))[None, :]
    key = jax.random.PRNGKey(42)
    out = {}
    for name in decoder_names:
        dec = mod.DECODERS[name](code, **{**KW, **kw})
        est, _ = dec.decode(y_batch, param, key)
        out[name] = np.asarray(est)[0]
    return out


# ----- BSC (reference bsc.py:78-92) -----

@pytest.mark.parametrize("code_name,x,y", [
    ("4_2_test", [1, 1, 0, 1, 1], [1, 0, 0, 1, 1]),
    ("7_4_hamming", [1, 0, 0, 1, 1, 0, 0], [1, 0, 1, 1, 1, 0, 0]),
])
def test_bsc_oracle(code_name, x, y):
    out = run_decoders("bsc", code_name, 0.1, ["ML", "SPA", "MSA"], x, y)
    for name, est in out.items():
        assert (est == np.asarray(x)).all(), f"{name} failed: {est}"


# ----- BEC (reference bec.py:128-139) -----

@pytest.mark.parametrize("code_name,x,y", [
    ("4_2_test", [1, 1, 0, 1, 1], [1, 2, 0, 1, 2]),
    ("7_4_hamming", [1, 0, 0, 1, 1, 0, 0], [2, 0, 2, 1, 1, 0, 2]),
])
def test_bec_oracle(code_name, x, y):
    out = run_decoders("bec", code_name, 1 / 3, ["ML", "SPA"], x, y)
    for name, est in out.items():
        assert (est == np.asarray(x)).all(), f"{name} failed: {est}"


# ----- biAWGN (reference biawgn.py:81-92) -----

@pytest.mark.parametrize("code_name,param,x,y", [
    ("4_2_test", 1.0, [1, 1, 0, 1, 1], [1, 1, 1.6, 0.9, 1]),
    ("7_4_hamming", 0.1, [1, 0, 0, 1, 1, 0, 0], [1, -1, 1.1, 1, 1, -1, -1]),
])
def test_biawgn_oracle(code_name, param, x, y):
    out = run_decoders("biawgn", code_name, param, ["ML", "SPA", "MSA"], x, y)
    for name, est in out.items():
        assert (est == np.asarray(x)).all(), f"{name} failed: {est}"


# ----- exhaustive Hamming(7,4) erasure grid for the erasure SPA + ML -----

def test_bec_hamming_recoverable_erasures():
    """For every codeword and every erasure pattern of weight <= 2, ML must
    recover (d_min = 3 so any 2 erasures are correctable); SPA must agree
    with ML whenever SPA fully resolves."""
    from ldpc_decoders_tpu.utils.math import binary_vectors
    code = codes.get_code("7_4_hamming")
    mod = CHANNELS["bec"]
    patterns = [p for p in binary_vectors(7) if p.sum() <= 2]
    xs, ys = [], []
    for cw in code.cb:
        for pat in patterns:
            xs.append(cw)
            ys.append(np.where(pat == 1, 2, cw))
    xs, ys = np.asarray(xs), np.asarray(ys)

    key = jax.random.PRNGKey(7)
    ml = mod.DECODERS["ML"](code)
    est_ml, _ = ml.decode(jnp.asarray(ys), 0.1, key)
    assert (np.asarray(est_ml) == xs).all()

    spa = mod.DECODERS["SPA"](code, max_iter=100)
    est_spa, _ = spa.decode(jnp.asarray(ys), 0.1, key)
    est_spa = np.asarray(est_spa)
    resolved = (est_spa != 2).all(axis=1)
    assert (est_spa[resolved] == xs[resolved]).all()
    # weight<=1 erasures always peel on the Hamming code
    weights = (ys == 2).sum(axis=1)
    assert resolved[weights <= 1].all()


def test_bp_zero_iterations_when_already_codeword():
    """A received word that is already a codeword must decode in 0
    iterations (syndrome early-exit before the first update,
    reference bpa.py:29)."""
    code = codes.get_code("7_4_hamming")
    mod = CHANNELS["bsc"]
    dec = mod.DECODERS["SPA"](code, max_iter=10)
    y = jnp.asarray(code.cb[:4])
    est, info = dec.decode(y, 0.1, jax.random.PRNGKey(0))
    assert (np.asarray(est) == code.cb[:4]).all()
    assert (np.asarray(info["iters"]) == 0).all()


def test_bp_max_iter_zero_unlimited():
    """max_iter <= 0 runs to the safety cap instead of stopping at once
    (reference bpa.py:28 semantics)."""
    code = codes.get_code("7_4_hamming")
    mod = CHANNELS["bsc"]
    dec = mod.DECODERS["SPA"](code, max_iter=0, iter_cap=50)
    x = np.array([1, 0, 0, 1, 1, 0, 0])
    y = jnp.asarray((x + np.eye(7, dtype=int)[2]) % 2)[None, :]
    est, _ = dec.decode(y, 0.1, jax.random.PRNGKey(0))
    assert (np.asarray(est)[0] == x).all()


def test_msa_matches_spa_on_easy_batch():
    """On a random low-noise batch, MSA and SPA agree with the sent word."""
    code = codes.get_code("12_3_4_ldpc")
    mod = CHANNELS["biawgn"]
    key = jax.random.PRNGKey(1)
    B = 64
    x = jnp.zeros((B, 12), dtype=jnp.int32)
    y = mod.send(key, x, 8.0)  # 8 dB: essentially noiseless
    for name in ["SPA", "MSA"]:
        dec = mod.DECODERS[name](code, max_iter=20)
        est, _ = dec.decode(y, 8.0, key)
        assert (np.asarray(est) == 0).mean() > 0.999, name


@pytest.mark.parametrize("code_name", ["7_4_hamming", "1200_3_6_ldpc",
                                       "1200_rho_x5_rand_ldpc_1"])
@pytest.mark.parametrize("variant", ["SPA", "MSA"])
def test_bp_perm_routes_bit_identical(code_name, variant):
    """The three variable-halfstep routes — incidence ([E,V] sum dot +
    broadcast dot, the default), matmul (one-hot E x E permutations) and
    gather (slot maps) — must produce bit-identical decisions AND
    iteration counts: each is an exact 0/1 linear map evaluated at
    HIGHEST precision, so any divergence is a routing bug, not noise."""
    from ldpc_decoders_tpu.decoders.bp import BPDecoder

    code = codes.get_code(code_name)
    llr = jax.random.normal(jax.random.PRNGKey(3),
                            (32, code.get_n())) * 4.0
    outs = {}
    for mode in ("incidence", "matmul", "gather"):
        dec = BPDecoder(code.graph, variant, max_iter=10, perm=mode)
        xh, it = dec.decode(llr)
        outs[mode] = (np.asarray(xh), np.asarray(it))
    for mode in ("matmul", "gather"):
        assert (outs["incidence"][0] == outs[mode][0]).all(), mode
        assert (outs["incidence"][1] == outs[mode][1]).all(), mode


def test_bp_f32_routes_tie_jitter_bound():
    """At deep-tie BSC operating points the f32 routes legitimately
    differ in SUMMATION ORDER of the per-variable marginal, and the odd
    exact tie flips: a handful of words per thousand differ in
    iteration count and the occasional already-errored word differs in
    its (wrong) decision bits. Pin that contract (every float route, and
    the GPU against the CPU in chip_smoke.py, is held to the same bar,
    ldpc_decoders_tpu/utils/compare.py); golden BSC agreement is and
    must be statistical, not bit-exact."""
    from ldpc_decoders_tpu.channels import bsc
    from ldpc_decoders_tpu.decoders.bp import BPDecoder

    code = codes.get_code("1200_3_6_ldpc")
    B = 512
    xw = jnp.zeros((B, code.get_n()), jnp.int32)
    y = bsc.send(jax.random.PRNGKey(11), xw, 0.02)
    llr = bsc.llr(y, 0.02)
    outs = {}
    for mode in ("incidence", "gather"):
        dec = BPDecoder(code.graph, "MSA", max_iter=10,
                        msg_dtype=jnp.float32, check_init=False, perm=mode)
        xh, it = jax.jit(dec.decode)(llr)
        outs[mode] = (np.asarray(xh), np.asarray(it))
    dec_mism = int((outs["incidence"][0] != outs["gather"][0])
                   .any(axis=1).sum())
    assert dec_mism <= 0.01 * B, dec_mism
    it_mism = int((outs["incidence"][1] != outs["gather"][1]).sum())
    assert it_mism <= 0.03 * B, it_mism
    assert it_mism + dec_mism > 0  # the jitter is real at this point
    assert (dec_mism, it_mism) == mismatch_counts(*outs["incidence"],
                                                  *outs["gather"])
    assert within_float_bar(dec_mism, it_mism, B)


@pytest.mark.parametrize("code_name", ["7_4_hamming", "1200_3_6_ldpc",
                                       "1200_rho_x5_rand_ldpc_1"])
@pytest.mark.parametrize("channel", ["bsc", "biawgn"])
def test_msa_matches_float64_oracle(code_name, channel):
    """BPDecoder MSA (float32) against the float64 min-sum oracle of
    tests/ref_semantics_oracle.py: decisions within the float bar. At
    BSC p=0.05 and biAWGN 2 dB no exact-tie sum is rounded, so iteration
    counts agree too."""
    from ldpc_decoders_tpu.channels import biawgn, bsc
    from ldpc_decoders_tpu.decoders.bp import BPDecoder
    from tests.ref_semantics_oracle import decode_msa_ref

    code = codes.get_code(code_name)
    B = 128
    xw = jnp.zeros((B, code.get_n()), jnp.int32)
    if channel == "bsc":
        llr = bsc.llr(bsc.send(jax.random.PRNGKey(1), xw, 0.05), 0.05)
    else:
        llr = biawgn.llr(biawgn.send(jax.random.PRNGKey(2), xw, 2.0), 2.0)
    check_init = channel != "biawgn"
    xh, it = BPDecoder(code.graph, "MSA", max_iter=20,
                       check_init=check_init).decode(llr)
    xr, ir = decode_msa_ref(code.parity_mtx, np.asarray(llr, np.float64),
                            20, check_init=check_init)
    dec, its = mismatch_counts(xh, it, xr, ir)
    assert within_float_bar(dec, its, B), (dec, its)
