"""Member rotation: one compiled chunk serving a whole code ensemble.

The reference runs ensembles as independent cluster jobs per member
(simulations.py:79-85). The rotating harness path decodes each member
through the SAME compiled program by feeding member tables as traced
arguments (harness/runner.py rotate_member): results must match a fresh
per-member runner bit-for-bit (same seeds), with no retrace on rotation.
"""

import dataclasses

import jax
import numpy as np
import pytest

from ldpc_decoders_tpu.codes import get_code
from ldpc_decoders_tpu.codes.ensembles import rand_reg_ldpc
from ldpc_decoders_tpu.codes.code import Code
from ldpc_decoders_tpu.harness import (
    MonteCarloRunner,
    RunConfig,
    run_rotating_members,
)


def _reg_members(n=48, l=3, r=6, count=3):
    rng = np.random.RandomState(7)
    return [Code(None, rand_reg_ldpc(n, l, r, rng)) for _ in range(count)]


def _register(codes, monkeypatch):
    """Expose plain Code objects through get_code's registry contract."""
    import ldpc_decoders_tpu.harness.runner as runner_mod
    table = {f"member_{i}": c for i, c in enumerate(codes)}

    def fake_get_code(name):
        return table.get(name) or get_code(name)

    monkeypatch.setattr(runner_mod, "get_code", fake_get_code)
    return list(table)


@pytest.mark.parametrize("channel,decoder,codeword", [
    ("bec", "SPA", 0),
    ("bsc", "MSA", 1),
    ("biawgn", "MSA", 1),
])
def test_rotation_matches_fresh_runner(channel, decoder, codeword,
                                       monkeypatch):
    codes = _reg_members()
    names = _register(codes, monkeypatch)
    cfg = RunConfig(channel, names[0], decoder,
                    params=[0.4 if channel != "biawgn" else 1.0],
                    codeword=codeword, max_iter=5, min_wec=20, batch=64,
                    seed=3)

    rot = MonteCarloRunner(cfg, rotating=True)
    assert rot.rotatable
    rotated = {}
    for i, name in enumerate(names):
        rot.rotate_member(name, seed=cfg.seed + i)
        rotated[name] = rot.run()

    for i, name in enumerate(names):
        fresh = MonteCarloRunner(
            dataclasses.replace(cfg, code=name, seed=cfg.seed + i))
        # Patch the fresh runner's code resolution too.
        fresh.code = codes[i]
        fresh.dec = fresh.mod.DECODERS[decoder](codes[i],
                                                **cfg.decoder_kwargs())
        want = fresh.run()
        got = rotated[name]
        for p, v in want.items():
            assert got[p]["tot"] == v["tot"]
            assert got[p]["wec"] == v["wec"], (name, p)
            assert got[p]["bec"] == v["bec"], (name, p)


def test_rotation_single_compilation(monkeypatch):
    codes = _reg_members()
    names = _register(codes, monkeypatch)
    cfg = RunConfig("bsc", names[0], "MSA", params=[0.05], codeword=1,
                    max_iter=5, min_wec=5, batch=64)
    runner = MonteCarloRunner(cfg, rotating=True)
    for i, name in enumerate(names):
        runner.rotate_member(name, seed=i)
        runner.run()
    # All members hit ONE jit cache entry: member identity is traced
    # argument data, not program structure.
    assert runner._chunk._cache_size() == 1


def test_rotation_irregular_edge_padding(monkeypatch):
    """Members with different edge counts (double-edge cancellation in
    irregular draws) share one program via common-length edge padding."""
    base = np.asarray(get_code("1200_rho_x5_rand_ldpc_1").parity_mtx)
    # Tiny irregular-ish members with unequal edge counts but equal
    # padded shapes: start from a regular draw and drop one edge pair.
    rng = np.random.RandomState(0)
    h1 = rand_reg_ldpc(48, 3, 6, rng)
    h2 = h1.copy()
    r = np.nonzero(h2.sum(axis=1) == 6)[0][0]
    c = np.nonzero(h2[r])[0][:1]
    h2[r, c] = 0  # one fewer edge; Dc/Dv padding unchanged
    assert h1.sum() != h2.sum()
    del base
    codes = [Code(None, h1), Code(None, h2)]
    names = _register(codes, monkeypatch)

    cfg = RunConfig("bec", names[0], "SPA", params=[0.35], codeword=0,
                    max_iter=10, min_wec=10, batch=64, seed=11)
    res = run_rotating_members(cfg, names)
    assert set(res) == set(names)
    for name in names:
        assert res[name][0.35]["tot"] > 0

    # Padded-table decode is exact: compare member 2 against a fresh
    # unpadded runner with identical seed.
    fresh = MonteCarloRunner(dataclasses.replace(cfg, code=names[1],
                                                 seed=cfg.seed + 1))
    fresh.code = codes[1]
    fresh.dec = fresh.mod.DECODERS["SPA"](codes[1], **cfg.decoder_kwargs())
    want = fresh.run()
    assert res[names[1]][0.35]["wec"] == want[0.35]["wec"]
    assert res[names[1]][0.35]["bec"] == want[0.35]["bec"]


@pytest.mark.parametrize("route", ["incidence", "matmul", "gather"])
def test_rotation_on_each_route_f32_bsc(route, monkeypatch):
    """Rotation swaps each BP route's member tables (one-hot matrices or
    slot maps) through the same compiled chunk: float32 BSC MSA, rotated
    vs fresh runner on the SAME route, must be bit-identical (the routes
    differ from each other only in summation order on exact ties)."""
    from ldpc_decoders_tpu.ops import perm as perm_ops

    monkeypatch.setattr(perm_ops, "auto_bp_perm", lambda g, d: route)
    codes = _reg_members(n=48, count=3)
    names = _register(codes, monkeypatch)
    base = RunConfig(channel="bsc", code=names[0], decoder="MSA",
                     params=[0.06], codeword=1, min_wec=20, batch=128,
                     max_iter=10, log_freq=1e9)
    res_rot = run_rotating_members(base, names)
    for i, name in enumerate(names):
        fresh = MonteCarloRunner(
            dataclasses.replace(base, code=name, seed=base.seed + i))
        assert fresh.dec.dec.perm == route
        assert fresh.dec.dec.msg_dtype == np.float32
        a, b = res_rot[name][0.06], fresh.run()[0.06]
        assert (a["tot"], a["wec"], a["bec"]) == \
            (b["tot"], b["wec"], b["bec"]), (name, a, b)


def test_rotation_rejects_random_codeword(monkeypatch):
    codes = _reg_members(count=2)
    names = _register(codes, monkeypatch)
    cfg = RunConfig("bsc", names[0], "MSA", params=[0.05], codeword=-1,
                    min_wec=2, batch=16)
    with pytest.raises(ValueError, match="codeword"):
        MonteCarloRunner(cfg, rotating=True).rotate_member(names[1])
    with pytest.raises(ValueError, match="rotation"):
        MonteCarloRunner(
            RunConfig("bsc", names[0], "ADMM", params=[0.05], min_wec=2),
            rotating=True)

