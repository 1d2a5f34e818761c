"""Iteration-cap snapshotting: decode_multi_cap must be bit-exact with a
separate decode at each cap (reference REG_BAD, simulations.py:74-77,
re-runs the Monte-Carlo per cap; one snapshotting pass replaces it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_decoders_tpu import get_code
from ldpc_decoders_tpu.channels import bec as bec_mod
from ldpc_decoders_tpu.channels import bsc as bsc_mod
from ldpc_decoders_tpu.decoders.bec_spa import BECSPADecoder
from ldpc_decoders_tpu.decoders.bp import BPDecoder
from ldpc_decoders_tpu.harness import RunConfig
from ldpc_decoders_tpu.harness.cap_sweep import CapSweepRunner

CAPS = [1, 2, 3, 6, 10, 40, 100]


@pytest.fixture(scope="module")
def code():
    return get_code("7_4_hamming")


@pytest.mark.parametrize("variant", ["SPA", "MSA"])
def test_bp_multi_cap_matches_per_cap(code, variant):
    key = jax.random.PRNGKey(3)
    x = jnp.ones((512, 7), jnp.int32)
    y = bsc_mod.send(key, x, 0.12)
    llr = bsc_mod.llr(y, 0.12)

    dec = BPDecoder(code.graph, variant, max_iter=CAPS[-1])
    x_hats, iters = dec.decode_multi_cap(llr, CAPS)
    assert x_hats.shape == (len(CAPS), 512, 7)
    for k, cap in enumerate(CAPS):
        ref_dec = BPDecoder(code.graph, variant, max_iter=cap)
        x_ref, it_ref = ref_dec.decode(llr)
        np.testing.assert_array_equal(np.asarray(x_hats[k]),
                                      np.asarray(x_ref), err_msg=f"cap {cap}")
        np.testing.assert_array_equal(np.asarray(iters[k]),
                                      np.asarray(it_ref), err_msg=f"cap {cap}")


def test_bec_spa_multi_cap_matches_per_cap(code):
    key = jax.random.PRNGKey(5)
    x = jnp.ones((512, 7), jnp.int32)
    y = bec_mod.send(key, x, 0.4)

    dec = BECSPADecoder(code.graph, max_iter=CAPS[-1])
    x_hats, iters = dec.decode_multi_cap(y, CAPS)
    for k, cap in enumerate(CAPS):
        x_ref, it_ref = BECSPADecoder(code.graph, max_iter=cap).decode(y)
        np.testing.assert_array_equal(np.asarray(x_hats[k]),
                                      np.asarray(x_ref), err_msg=f"cap {cap}")
        np.testing.assert_array_equal(np.asarray(iters[k]),
                                      np.asarray(it_ref), err_msg=f"cap {cap}")


def test_cap_sweep_runner_end_to_end(tmp_path):
    """All caps tallied from one pass; per-cap files named exactly as a
    per-cap MonteCarloRunner would name them; error counts monotonically
    non-increasing in the cap (same noise realizations). Label 0 = raw
    channel output (golden-vintage semantics: the reference's committed
    *-0-* cap files score x_hat = y untouched, WER 1 at any real
    crossover); label -1 = run to convergence (current reference
    max_iter <= 0 semantics)."""
    cfg = RunConfig(channel="bsc", code="7_4_hamming", decoder="MSA",
                    params=[0.08], codeword=1, min_wec=30, batch=256,
                    data_dir=str(tmp_path), log_freq=1e9, iter_cap=500)
    caps = [0, 1, 3, 10, -1]
    res = CapSweepRunner(cfg, caps).run()
    assert set(res.keys()) == set(caps)
    wecs = {c: res[c][0.08]["wec"] for c in caps}
    assert wecs[0] >= wecs[1] >= wecs[3] >= wecs[10] >= wecs[-1]
    # raw-output slot: every word with >= 1 flip errors; BER = p approx.
    tot = res[0][0.08]["tot"]
    assert res[0][0.08]["wec"] >= 0.35 * tot   # 1-(1-.08)^7 ~ 0.44
    for c in caps:
        f = tmp_path / f"bsc-7_4_hamming-MSA-1-30-{c}.json"
        assert f.exists(), list(tmp_path.iterdir())
        assert res[c][0.08]["wec"] >= 30 or res[c][0.08]["tot"] >= 256


def test_cap_sweep_zero_label_biawgn(tmp_path):
    """biAWGN raw-output slot: the golden vintage compared REAL y to the
    bits, so WER = BER = 1 exactly (reference
    biawgn-1200_3_6_ldpc-SPA-0-0.json is 1.0 everywhere)."""
    cfg = RunConfig(channel="biawgn", code="7_4_hamming", decoder="SPA",
                    params=[2.0], codeword=1, min_wec=10, batch=128,
                    data_dir=str(tmp_path), log_freq=1e9)
    res = CapSweepRunner(cfg, [0, 10]).run()
    s = res[0][2.0]
    assert s["wer"] == 1.0 and s["ber"] == 1.0
    assert res[10][2.0]["wer"] < 0.5


# ---- multi-cap snapshots on every route, full-width code ------------------

@pytest.fixture(scope="module")
def reg_code():
    return get_code("1200_3_6_ldpc")


PCAPS = [1, 2, 3, 6]
ROUTES = ["incidence", "matmul", "gather"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("route", ROUTES)
def test_multi_cap_msa_matches_per_cap_on_route(reg_code, dtype, route):
    """MSA snapshot planes on each route are bit-equal to separate
    decodes at each cap through the same route."""
    key = jax.random.PRNGKey(11)
    x = jnp.ones((64, 1200), jnp.int32)
    llr = bsc_mod.llr(bsc_mod.send(key, x, 0.06), 0.06)
    dt = jnp.dtype(dtype)
    dec = BPDecoder(reg_code.graph, "MSA", max_iter=PCAPS[-1],
                    msg_dtype=dt, perm=route)
    xs, its = dec.decode_multi_cap(llr, PCAPS)
    for k, cap in enumerate(PCAPS):
        xr, ir = BPDecoder(reg_code.graph, "MSA", max_iter=cap,
                           msg_dtype=dt, perm=route).decode(llr)
        np.testing.assert_array_equal(np.asarray(xs[k]), np.asarray(xr),
                                      err_msg=f"cap {cap}")
        np.testing.assert_array_equal(np.asarray(its[k]), np.asarray(ir),
                                      err_msg=f"iters cap {cap}")


@pytest.mark.parametrize("policy", ["saturate", "reference"])
@pytest.mark.parametrize("route", ROUTES)
def test_multi_cap_spa_matches_per_cap_on_route(reg_code, policy, route):
    """SPA snapshot planes (both inf policies, float32) are bit-exact
    with separate decodes at each cap through the same route."""
    key = jax.random.PRNGKey(12)
    x = jnp.ones((32, 1200), jnp.int32)
    llr = bsc_mod.llr(bsc_mod.send(key, x, 0.07), 0.07)
    dec = BPDecoder(reg_code.graph, "SPA", max_iter=PCAPS[-1],
                    inf_policy=policy, perm=route)
    xs, its = dec.decode_multi_cap(llr, PCAPS)
    for k, cap in enumerate(PCAPS):
        xr, ir = BPDecoder(reg_code.graph, "SPA", max_iter=cap,
                           inf_policy=policy, perm=route).decode(llr)
        np.testing.assert_array_equal(np.asarray(xs[k]), np.asarray(xr),
                                      err_msg=f"cap {cap}")
        np.testing.assert_array_equal(np.asarray(its[k]), np.asarray(ir),
                                      err_msg=f"iters cap {cap}")


def test_multi_cap_bec_full_width(reg_code):
    """Ternary BEC snapshots on the full-width code, including
    stopping-set freezes, equal per-cap decodes."""
    key = jax.random.PRNGKey(13)
    x = jnp.ones((64, 1200), jnp.int32)
    y = bec_mod.send(key, x, 0.4)
    xs, its = BECSPADecoder(reg_code.graph,
                            max_iter=PCAPS[-1]).decode_multi_cap(y, PCAPS)
    for k, cap in enumerate(PCAPS):
        xr, ir = BECSPADecoder(reg_code.graph, max_iter=cap).decode(y)
        np.testing.assert_array_equal(np.asarray(xs[k]), np.asarray(xr))
        np.testing.assert_array_equal(np.asarray(its[k]), np.asarray(ir))


@pytest.mark.parametrize("route", ROUTES)
def test_cap_sweep_runner_tallies_on_route(reg_code, route, monkeypatch):
    """CapSweepRunner through each BP route (forced via the "auto"
    policy): the REG_BAD campaign contract — every route's per-cap
    tallies agree with the gather route's within the float bar (BSC
    float32 ties), the raw-output slot exactly."""
    from ldpc_decoders_tpu.ops import perm as perm_ops

    kw = dict(channel="bsc", code="1200_3_6_ldpc", decoder="MSA",
              params=[0.06], codeword=1, min_wec=5, batch=64,
              max_words=128, log_freq=1e9)
    res = {}
    for r in ("gather", route):
        monkeypatch.setattr(perm_ops, "auto_bp_perm", lambda g, d, r=r: r)
        runner = CapSweepRunner(RunConfig(**kw), [0] + PCAPS)
        assert runner.dec.perm == r
        res[r] = runner.run()
    for lbl in [0] + PCAPS:
        sg, sr = res["gather"][lbl][0.06], res[route][lbl][0.06]
        assert sg["tot"] == sr["tot"]
        bar = 0 if lbl == 0 else 0.01 * sg["tot"]
        assert abs(sg["wec"] - sr["wec"]) <= bar, (lbl, sg, sr)
