"""End-to-end smoke check of the Monte-Carlo campaign path on a GPU.

    python chip_smoke.py             # one card: phases 1-6 below
    python chip_smoke.py --chips 4   # the four-card mesh phase only

One process drives the card. With no option it runs, in order:

1. device   -- JAX's default backend must be a CUDA GPU (no CPU fallback);
2. cli      -- ``ldpc_decoders_tpu.main`` sweeps biAWGN MSA on LDPC(1200,3,6)
               at batch 16384; each point's WER must sit within 4 sigma of
               the committed curve in artifacts/data;
3. campaign -- ``ldpc_decoders_tpu.campaign REG_ENS`` rotates the ten
               LDPC(1200,3,6) ensemble members through one compiled chunk
               per sweep (member rotation: tables as traced arguments) at
               batch 16384, one chunk per point; every point's WER must
               sit within the golden bar (5 Agresti-Coull sigma + 0.01)
               of the member's committed curve;
4. lt       -- ``ldpc_decoders_tpu.fountain.lt`` at golden scale (k=10000,
               n=12000) streams two batches of sims; the results must equal
               the sparse engine's on the CPU for the same graphs, and their
               mean must sit within 4 sigma of the committed histogram's;
5. families -- every decoder family decodes one fixed draw at full width on
               the GPU and on the CPU through the same route: bit-identical
               where the arithmetic is integer, within the float-route bar
               (utils/compare.py) otherwise; batches are also checked
               against the float64 oracles in tests/ref_semantics_oracle.py;
6. routes   -- times every XLA data-movement route of each family at batch
               16384 (the numbers PERF.md records).

Every reported number is printed beside the card's ``nvidia-smi`` name and
power limit. Any failed check raises, so the script exits non-zero; the
last line of a passing run is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from types import SimpleNamespace

CLI_ARGS = ["biawgn", "1200_3_6_ldpc", "MSA", "--params", "2.0", "2.5",
            "--codeword", "1", "--min-wec", "100", "--batch", "16384"]
CLI_GOLDEN = "artifacts/data/biawgn-1200_3_6_ldpc-MSA-1-100-10.json"
CLI_SIGMA = 4.0
# REG_ENS: 10 members x 5 sweeps, 62 points per member, one chunk each.
# Every point is held to the golden bar of utils/compare.py (the one
# tests/test_harness.py holds regenerated member curves to).
CAMPAIGN_ARGS = ["REG_ENS", "--batch", "16384", "--max-words", "16384"]
CAMPAIGN_FILES = 50
LT_CLI_ARGS = ["10000", "12000", "0.03", "0.5", "8", "--batch", "4"]
LT_GOLDEN = "artifacts/data/luby-10000-12000-0.03-0.5.json"
FAMILY_BATCH = 4096     # LDPC(1200,3,6) families, GPU vs CPU
MARGULIS_BATCH = 1024   # margulis ADMM at cap 200 (the CPU side is slow)
ORACLE_BATCH = 128      # float64 numpy oracles, float32 messages
ROUTE_BATCH = 16384
ROUTE_REPS = 3
LT_K, LT_N, LT_SIMS = 10000, 12000, 8     # golden scale

CARD = "card not queried"


class SmokeFailure(AssertionError):
    """A smoke check did not hold."""


def select_phases(chips: int) -> tuple:
    """Phases a run with ``--chips`` executes: the one-card path, or the
    four-card mesh phase alone."""
    if chips == 1:
        return ("device", "cli", "campaign", "lt", "families", "routes")
    if chips == 4:
        return ("device", "mesh")
    raise ValueError(f"--chips must be 1 or 4, not {chips}")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg} | {CARD}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def float_bar_line(name, prec, dec, it, n) -> tuple:
    """(printed line, passed) of one comparison under the float-route
    bar."""
    from ldpc_decoders_tpu.utils.compare import within_float_bar

    ok = within_float_bar(dec, it, n)
    return (f"{name} [{prec}]: {dec}/{n} words differ in decisions, "
            f"{it}/{n} in iterations -> {'ok' if ok else 'FAIL'}"), ok


# ----------------------------------------------------------------------
# 1. device
# ----------------------------------------------------------------------

def phase_device(chips: int) -> dict:
    import jax

    from ldpc_decoders_tpu.utils.device import card_line, require_gpu

    global CARD
    info = require_gpu()
    check(info["count"] >= chips,
          f"need {chips} GPUs, JAX sees {info['count']}")
    CARD = f"card: {card_line()}"
    say("device", f"backend {jax.default_backend()}, {info['count']} x "
        f"{info['kind']}, jax {jax.__version__}")
    return info


# ----------------------------------------------------------------------
# 2. the CLI path
# ----------------------------------------------------------------------

def phase_cli() -> None:
    import os

    from ldpc_decoders_tpu import main as cli
    from ldpc_decoders_tpu.utils.compare import wer_sigma_gap
    from ldpc_decoders_tpu.utils.file import load_json

    golden = load_json(CLI_GOLDEN)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli.main(CLI_ARGS + ["--data_dir", tmp])
        dt = time.perf_counter() - t0
        out = load_json(os.path.join(
            tmp, "biawgn-1200_3_6_ldpc-MSA-1-100-10.json"))
    check(out is not None, "the CLI wrote no Saver JSON")
    for param in CLI_ARGS[4:6]:
        key = str(float(param))
        tot, wer = out["tot"][key], out["wer"][key]
        g_tot, g_wer = golden["tot"][key], golden["wer"][key]
        gap = wer_sigma_gap(wer, tot, g_wer, g_tot)
        say("cli", f"biAWGN MSA-10 {key} dB: WER {wer} over {tot} words "
            f"(wec {out['wec'][key]}, {out['words_per_sec'][key]} cw/s) vs "
            f"golden {g_wer} over {g_tot}: {gap:.2f} sigma")
        check(gap <= CLI_SIGMA, f"CLI WER at {key} dB is {gap:.2f} sigma "
              f"from the golden curve")
    say("cli", f"sweep wall time {dt:.1f} s (compilation included)")


def golden_gaps(out: dict, golden: dict) -> list:
    """[(param key, wer, tot, golden wer, golden tot, signed sigma gap,
    |difference| / golden allowance)] for every point of a Saver JSON
    ``out``, matched to ``golden`` by parameter value (the two may format
    the same float differently). A point passes when the last field is
    below 1."""
    from ldpc_decoders_tpu.utils.compare import (
        golden_allowance,
        wer_sigma_gap,
    )

    by_value = {round(float(k), 9): k for k in golden["tot"]}
    rows = []
    for key in out["tot"]:
        g_key = by_value.get(round(float(key), 9))
        check(g_key is not None, f"golden curve has no point at {key}")
        wer, tot = out["wer"][key], out["tot"][key]
        g_wer, g_tot = golden["wer"][g_key], golden["tot"][g_key]
        sign = 1.0 if wer >= g_wer else -1.0
        rows.append((key, wer, tot, g_wer, g_tot,
                     sign * wer_sigma_gap(wer, tot, g_wer, g_tot),
                     abs(wer - g_wer) / golden_allowance(wer, tot, g_wer,
                                                         g_tot)))
    return rows


# ----------------------------------------------------------------------
# 3. the campaign CLI, member rotation
# ----------------------------------------------------------------------

def phase_campaign() -> None:
    import glob
    import os

    from ldpc_decoders_tpu import campaign
    from ldpc_decoders_tpu.utils.file import load_json

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        campaign.main(CAMPAIGN_ARGS + ["--data_dir", tmp])
        dt = time.perf_counter() - t0
        outs = {os.path.basename(f): load_json(f)
                for f in sorted(glob.glob(os.path.join(tmp, "*.json")))}
    check(len(outs) == CAMPAIGN_FILES, f"campaign wrote {len(outs)} result "
          f"files, expected {CAMPAIGN_FILES}")
    n_points = n_words = 0
    worst = (0.0, "")
    sweeps = {}     # sweep (file name without the member) -> signed gaps
    for name, out in outs.items():
        golden = load_json(os.path.join("artifacts", "data", name))
        check(golden is not None, f"no committed curve for {name}")
        rows = golden_gaps(out, golden)
        key, wer, tot, g_wer, g_tot, z, frac = max(rows, key=lambda r: r[-1])
        n_points += len(rows)
        n_words += sum(r[2] for r in rows)
        say("campaign", f"{name}: {len(rows)} points, nearest the bar at "
            f"{key}: WER {wer} over {tot} words vs golden {g_wer} over "
            f"{g_tot} ({z:+.2f} sigma, {frac:.2f} of the allowance)")
        worst = max(worst, (frac, f"{name} at {key}"))
        sweep = name.split("-")[0] + "-" + "-".join(name.split("-")[2:])
        sweeps.setdefault(sweep, []).extend(
            r[5] for r in rows if 0 < r[3] < 1)
    for sweep, zs in sorted(sweeps.items()):
        say("campaign", f"{sweep} over 10 members: mean signed gap "
            f"{sum(zs) / len(zs):+.2f} sigma over {len(zs)} points with "
            f"0 < golden WER < 1")
    line = (f"REG_ENS rotated: {len(outs)} member sweeps, {n_points} "
            f"points, {n_words} words in {dt:.1f} s (compilation "
            f"included); nearest the golden bar {worst[0]:.2f} of the "
            f"allowance ({worst[1]}) -> {'ok' if worst[0] < 1 else 'FAIL'}")
    say("campaign", line)
    check(worst[0] < 1, line)


# ----------------------------------------------------------------------
# 4. the LT CLI at golden scale
# ----------------------------------------------------------------------

def lt_mean_gap(arr, golden_arr) -> float:
    """|mean(arr) - mean(golden_arr)| in units of the two means' combined
    standard error."""
    import numpy as np

    a, g = np.asarray(arr, float), np.asarray(golden_arr, float)
    se = np.sqrt(a.var(ddof=1) / a.size + g.var(ddof=1) / g.size)
    return float(abs(a.mean() - g.mean()) / se)


def phase_lt_cli() -> None:
    import os

    import jax
    import numpy as np

    from ldpc_decoders_tpu.fountain import lt
    from ldpc_decoders_tpu.utils.file import load_json

    k, n, c, delta, count = LT_CLI_ARGS[:5]
    batch = int(LT_CLI_ARGS[-1])
    name = f"luby-{k}-{n}-{c}-{delta}.json"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        lt.main(LT_CLI_ARGS + ["--data_dir", tmp])
        dt = time.perf_counter() - t0
        out = load_json(os.path.join(tmp, name))
    check(out is not None, "the LT CLI wrote no Saver JSON")
    arr = np.asarray(out["arr"])
    check(arr.size == int(count), f"LT CLI saved {arr.size} sims, asked "
          f"for {count}")

    # The CLI draws its graphs from default_rng([seed=0, #existing=0]),
    # one batch after another: replay that stream on the CPU.
    with jax.default_device(jax.devices("cpu")[0]):
        sim = lt.LTSimulator(int(k), int(n), float(c), float(delta),
                             engine="sparse")
        rng = np.random.default_rng([0, 0])
        ref = np.concatenate([sim.run(rng, batch)[0]
                              for _ in range(arr.size // batch)])
    same = bool((arr == ref).all())
    line = (f"LT CLI k={k} n={n} c={c}: {arr.size} sims in {dt:.1f} s "
            f"(compilation included) vs sparse engine on CPU, same graphs "
            f"[int]: {'bit-identical' if same else 'DIFFERENT'}")
    say("lt", line)
    check(same, line)

    golden = load_json(LT_GOLDEN)["arr"]
    gap = lt_mean_gap(arr, golden)
    line = (f"LT CLI mean symbols needed {arr.mean():.1f} vs golden "
            f"{np.mean(golden):.1f} over {len(golden)} sims: {gap:.2f} "
            f"sigma (bar {CLI_SIGMA}) -> {'ok' if gap <= CLI_SIGMA else 'FAIL'}")
    say("lt", line)
    check(gap <= CLI_SIGMA, line)


# ----------------------------------------------------------------------
# 5. every family, GPU vs CPU
# ----------------------------------------------------------------------

def _fresh_code(name, dev):
    """A Code whose edge tables live on ``dev`` (the registry's cached
    Code keeps them wherever they were first built)."""
    import jax

    from ldpc_decoders_tpu.codes import Code, get_code

    base = get_code(name)
    with jax.default_device(dev):
        code = Code(base.gen_mtx, base.parity_mtx)
        code.graph  # noqa: B018 - build the tables on dev
    return code


def _decode_on(dev, code_name, build, args):
    """Build a decoder on ``dev`` and jit-decode ``args`` there. Returns
    (x_hat, iters or None, perm, seconds including compilation)."""
    import jax
    import numpy as np

    code = _fresh_code(code_name, dev)
    with jax.default_device(dev):
        dec = build(code)
        put = [jax.device_put(a, dev) for a in args]
        t0 = time.perf_counter()
        out = jax.block_until_ready(jax.jit(dec.decode)(*put))
        dt = time.perf_counter() - t0
    perm = getattr(dec, "perm", "gather")   # BEC SPA has one route
    if isinstance(out, tuple):
        return np.asarray(out[0]), np.asarray(out[1]), perm, dt
    return np.asarray(out), None, perm, dt


def _draw(channel, code_name, param, batch, seed, codeword=0):
    """One fixed channel draw on the CPU -> (y, llr) numpy arrays."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ldpc_decoders_tpu.channels import CHANNELS
    from ldpc_decoders_tpu.codes import get_code

    mod = CHANNELS[channel]
    n = get_code(code_name).get_n()
    with jax.default_device(jax.devices("cpu")[0]):
        x = jnp.full((batch, n), codeword, jnp.int32)
        y = mod.send(jax.random.PRNGKey(seed), x, param)
        llr = mod.llr(y, param) if channel != "bec" else None
    return np.asarray(y), None if llr is None else np.asarray(llr)


def _load_oracle():
    """tests/ref_semantics_oracle.py, loaded by path: an installed
    package named ``tests`` may shadow the repository's directory."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "ref_semantics_oracle.py")
    spec = importlib.util.spec_from_file_location("ref_semantics_oracle",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _families():
    """(name, code, channel, param, builder, input kind, bar, precision)."""
    import jax.numpy as jnp

    from ldpc_decoders_tpu.decoders.admm import ADMMDecoder
    from ldpc_decoders_tpu.decoders.bec_spa import BECSPADecoder
    from ldpc_decoders_tpu.decoders.bp import BPDecoder

    reg = "1200_3_6_ldpc"

    def bp(variant, dtype, check_init, policy="reference"):
        return lambda c: BPDecoder(c.graph, variant, max_iter=10,
                                   msg_dtype=dtype, check_init=check_init,
                                   inf_policy=policy)

    return [
        ("biAWGN SPA-ref", reg, "biawgn", 3.0,
         bp("SPA", jnp.float32, False), "llr", "float", "f32, HIGHEST"),
        ("biAWGN SPA-ref", reg, "biawgn", 3.0,
         bp("SPA", jnp.bfloat16, False), "llr", "float", "bf16"),
        ("biAWGN MSA", reg, "biawgn", 3.0,
         bp("MSA", jnp.bfloat16, False), "llr", "float", "bf16"),
        ("BSC MSA", reg, "bsc", 0.02,
         bp("MSA", jnp.float32, True), "llr", "float", "f32, HIGHEST"),
        ("BSC SPA-ref", reg, "bsc", 0.02,
         bp("SPA", jnp.float32, True), "llr", "float", "f32, HIGHEST"),
        ("BEC ternary SPA", reg, "bec", 0.35,
         lambda c: BECSPADecoder(c.graph, max_iter=10), "y", "exact",
         "int"),
        ("biAWGN ADMM cap 50", reg, "biawgn", 3.0,
         lambda c: ADMMDecoder(c.graph, max_iter=50), "llr", "float",
         "f32"),
        ("margulis BSC ADMM cap 200", "margulis", "bsc", 0.06,
         lambda c: ADMMDecoder(c.graph, max_iter=200), "llr", "float",
         "f32"),
    ]


def _ml_families():
    from ldpc_decoders_tpu.decoders.ml import MLBEC, MLBSC, MLBiAWGN

    return [("ML Hamming(7,4) BSC", "bsc", 0.1, MLBSC, "exact"),
            ("ML Hamming(7,4) BEC", "bec", 0.3, MLBEC, "exact"),
            ("ML Hamming(7,4) biAWGN", "biawgn", 2.0, MLBiAWGN, "float")]


def _compare(phase, name, prec, bar, a, b, n):
    """Print one GPU-vs-reference comparison; raise if it misses its
    bar."""
    from ldpc_decoders_tpu.utils.compare import mismatch_counts

    dec, it = mismatch_counts(a[0], a[1], b[0], b[1])
    if bar == "exact":
        ok = dec == 0 and it == 0
        line = (f"{name} [{prec}]: {dec}/{n} words differ in decisions, "
                f"{it}/{n} in iterations (bit-identical required) -> "
                f"{'ok' if ok else 'FAIL'}")
    else:
        line, ok = float_bar_line(name, prec, dec, it, n)
    say(phase, line)
    check(ok, line)


def phase_families() -> dict:
    """Returns the LT engines' GPU times for the route phase."""
    import jax
    import numpy as np

    from ldpc_decoders_tpu.codes import get_code

    oracle = _load_oracle()
    decode_bec_ref = oracle.decode_bec_ref
    decode_msa_ref = oracle.decode_msa_ref
    decode_spa_ref = oracle.decode_spa_ref

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    for seed, (name, code_name, channel, param, build, kind, bar,
               prec) in enumerate(_families()):
        batch = MARGULIS_BATCH if code_name == "margulis" else FAMILY_BATCH
        y, llr = _draw(channel, code_name, param, batch, seed + 1)
        inp = [llr if kind == "llr" else y]
        xg, ig, perm, tg = _decode_on(gpu, code_name, build, inp)
        xc, ic, perm_c, tc = _decode_on(cpu, code_name, build, inp)
        check(perm == perm_c, f"{name}: routes differ ({perm}/{perm_c})")
        wer = float((xg != 0).any(1).mean())     # codeword 0 throughout
        say("families", f"{name} at {param}, {code_name}, batch {batch}, "
            f"route {perm}: GPU {tg:.2f} s / CPU {tc:.2f} s (first call, "
            f"compilation included), GPU WER {wer:.4f}")
        _compare("families", f"{name} GPU vs CPU", prec, bar,
                 (xg, ig), (xc, ic), batch)

        # Against the float64 numpy oracles: a small batch for float32
        # messages, the whole draw for bfloat16.
        if channel == "bec" and "ADMM" not in name:
            pm = get_code(code_name).parity_mtx
            x_or = np.stack([decode_bec_ref(pm, y[b], 10)
                             for b in range(ORACLE_BATCH)])
            _compare("families", f"{name} GPU vs oracle", prec, "exact",
                     (xg[:ORACLE_BATCH], None), (x_or, None), ORACLE_BATCH)
        elif "SPA-ref" in name or name.endswith("MSA"):
            pm = get_code(code_name).parity_mtx
            n_or = batch if prec == "bf16" else ORACLE_BATCH
            l64 = llr[:n_or].astype(np.float64)
            if "SPA" in name:
                x_or, i_or = decode_spa_ref(pm, l64, 10), None
            else:
                x_or, i_or = decode_msa_ref(pm, l64, 10,
                                            check_init=(channel != "biawgn"))
            if prec == "bf16":
                _oracle_wer_check(name, xg, x_or)
            else:
                if i_or is not None:
                    n_it = int((ig[:ORACLE_BATCH] != i_or).sum())
                    say("families", f"{name} GPU vs float64 oracle: "
                        f"{n_it}/{ORACLE_BATCH} words differ in iterations "
                        f"(not held: float64 sums exact ties that float32 "
                        f"rounds, e.g. 3x an LLR)")
                _compare("families", f"{name} GPU vs float64 oracle", prec,
                         "float", (xg[:ORACLE_BATCH], None), (x_or, None),
                         ORACLE_BATCH)

    for seed, (name, channel, param, cls, bar) in enumerate(_ml_families()):
        y, _ = _draw(channel, "7_4_hamming", param, FAMILY_BATCH, 100 + seed)
        key = np.asarray(jax.random.PRNGKey(seed))

        def build(code, cls=cls, param=param):
            dec = cls(code)      # bound to its channel parameter
            return SimpleNamespace(decode=lambda y, k: dec.decode(y, param,
                                                                  k))
        xg, _, _, _ = _decode_on(gpu, "7_4_hamming", build, [y, key])
        xc, _, _, _ = _decode_on(cpu, "7_4_hamming", build, [y, key])
        _compare("families", f"{name} GPU vs CPU",
                 "int" if bar == "exact" else "f32, HIGHEST", bar,
                 (xg, None), (xc, None), FAMILY_BATCH)

    _admma_check(gpu, cpu)
    _cap_sweep_check(gpu, cpu)
    return _lt_check(gpu, cpu)


def _oracle_wer_check(name, x_gpu, x_or) -> None:
    """bfloat16 messages against the float64 oracle, over the whole draw.
    Two bars: words whose decisions differ stay under the float-route
    decision bar (1% of words; bfloat16 rounding flips only words near
    the decision boundary, 3 and 13 of 4096 on the CPU for SPA-ref and
    MSA at 3 dB), and the word error rates sit within 4 sigma (the
    golden-curve bar)."""
    from ldpc_decoders_tpu.utils.compare import (
        DEC_WORD_FRAC,
        mismatch_counts,
        wer_sigma_gap,
    )

    n = len(x_or)
    dec, _ = mismatch_counts(x_gpu, None, x_or, None)
    w_g = float((x_gpu != 0).any(1).mean())
    w_o = float((x_or != 0).any(1).mean())
    gap = wer_sigma_gap(w_g, n, w_o, n)
    ok = gap <= CLI_SIGMA and dec <= DEC_WORD_FRAC * n
    line = (f"{name} GPU vs float64 oracle [bf16]: {dec}/{n} words differ "
            f"in decisions (bar {DEC_WORD_FRAC:.0%}); WER {w_g:.4f} vs "
            f"{w_o:.4f} = {gap:.2f} sigma (bar {CLI_SIGMA}) -> "
            f"{'ok' if ok else 'FAIL'}")
    say("families", line)
    check(ok, line)


def _admma_check(gpu, cpu) -> None:
    """ADMMA's MLP matmuls run at the default precision (TF32 on the
    GPU's tensor cores): its WER on the card must sit within Monte-Carlo
    bounds (4 sigma) of the CPU's on the same draw. The committed model
    (cache/model_6-100-100-6.npz) projects for 10 iterations, then the
    exact projection takes over (``apprx``)."""
    import os

    import jax
    import numpy as np

    from ldpc_decoders_tpu.decoders.admma import ADMMADecoder
    from ldpc_decoders_tpu.utils.compare import (
        mismatch_counts,
        wer_sigma_gap,
    )

    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "cache")
    _, llr = _draw("biawgn", "1200_3_6_ldpc", 3.0, FAMILY_BATCH, 400)
    outs = []
    for dev in (gpu, cpu):
        code = _fresh_code("1200_3_6_ldpc", dev)
        with jax.default_device(dev):
            dec = ADMMADecoder(code.graph, max_iter=60, apprx=10,
                               cache_dir=cache)
            x, it = dec.decode(jax.device_put(llr, dev))
            outs.append((np.asarray(x), np.asarray(it)))
    (xg, ig), (xc, ic) = outs
    dec_m, it_m = mismatch_counts(xg, ig, xc, ic)
    n = FAMILY_BATCH
    w_g, w_c = float((xg != 0).any(1).mean()), float((xc != 0).any(1).mean())
    gap = wer_sigma_gap(w_g, n, w_c, n)
    ok = gap <= CLI_SIGMA
    line = (f"ADMMA (MLP 10 it, then exact; cap 60) biAWGN 3.0 dB GPU vs "
            f"CPU [f32, default matmul precision]: WER {w_g:.4f} vs "
            f"{w_c:.4f} = {gap:.2f} sigma (bar {CLI_SIGMA}); {dec_m}/{n} "
            f"words differ in decisions, {it_m}/{n} in iterations -> "
            f"{'ok' if ok else 'FAIL'}")
    say("families", line)
    check(ok, line)


def _cap_sweep_check(gpu, cpu) -> None:
    """CapSweepRunner's multi-cap decode: the runner's own GPU decoder vs a
    CPU twin (float bar at every cap), and a short GPU campaign whose
    per-cap error counts must not grow with the cap."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ldpc_decoders_tpu.decoders.bec_spa import BECSPADecoder
    from ldpc_decoders_tpu.decoders.bp import BPDecoder
    from ldpc_decoders_tpu.harness import RunConfig
    from ldpc_decoders_tpu.harness.cap_sweep import CapSweepRunner

    labels = [0, 1, 2, 3, 6, 10]
    for channel, param, bar in (("bsc", 0.02, "float"),
                                ("bec", 0.35, "exact")):
        cfg = RunConfig(channel=channel, code="1200_3_6_ldpc",
                        decoder="MSA" if channel == "bsc" else "SPA",
                        params=[param], codeword=0, min_wec=100,
                        batch=FAMILY_BATCH, max_words=4 * FAMILY_BATCH,
                        log_freq=1e9)
        runner = CapSweepRunner(cfg, labels)
        res = runner.run()
        wecs = [res[c][param]["wec"] for c in labels]
        say("families", f"CapSweepRunner {channel} {cfg.decoder} {param}: "
            f"caps {labels} wec {wecs} over {res[0][param]['tot']} words")
        check(all(a >= b for a, b in zip(wecs, wecs[1:])),
              f"cap-sweep errors grow with the cap: {wecs}")

        y, llr = _draw(channel, cfg.code, param, FAMILY_BATCH, 200)
        inp = y if channel == "bec" else llr
        caps = runner.caps

        def twin(code):
            if channel == "bec":
                return BECSPADecoder(code.graph, max_iter=caps[-1],
                                     iter_cap=cfg.iter_cap)
            return BPDecoder(code.graph, "MSA", max_iter=caps[-1],
                             iter_cap=cfg.iter_cap, msg_dtype=jnp.float32,
                             inf_policy=cfg.inf_policy, check_init=True)

        with jax.default_device(gpu):
            xg, ig = jax.jit(lambda v: runner.dec.decode_multi_cap(
                v, caps))(jax.device_put(inp, gpu))
        code_c = _fresh_code(cfg.code, cpu)
        with jax.default_device(cpu):
            dec_c = twin(code_c)
            xc, ic = jax.jit(lambda v: dec_c.decode_multi_cap(v, caps))(
                jax.device_put(inp, cpu))
        for k, cap in enumerate(caps):
            _compare("families",
                     f"CapSweepRunner {channel} multi-cap, cap {cap}, "
                     f"GPU vs CPU", "int" if bar == "exact" else "f32", bar,
                     (np.asarray(xg[k]), np.asarray(ig[k])),
                     (np.asarray(xc[k]), np.asarray(ic[k])), FAMILY_BATCH)


def _lt_check(gpu, cpu) -> dict:
    """LT at golden scale: dense and sparse engines on the GPU, and the
    sparse engine on the CPU, must agree bit for bit on the same graphs.
    Returns the second GPU run's seconds per engine, for the route
    phase."""
    import jax
    import numpy as np

    from ldpc_decoders_tpu.fountain.lt import LTSimulator

    k, n = LT_K, LT_N
    outs, gpu_times = {}, {}
    for engine, dev, where in (("dense", gpu, "gpu"), ("sparse", gpu, "gpu"),
                               ("sparse", cpu, "cpu")):
        with jax.default_device(dev):
            sim = LTSimulator(k, n, 0.03, 0.5, engine=engine)
            tables = sim.sample_batch(np.random.default_rng(11), LT_SIMS)
            t0 = time.perf_counter()
            out = [np.asarray(a) for a in sim.simulate(tables)]
            t_first = time.perf_counter() - t0
            if where == "gpu":
                t0 = time.perf_counter()
                [np.asarray(a) for a in sim.simulate(tables)]
                gpu_times[engine] = time.perf_counter() - t0
        outs[(engine, where)] = out
        say("families", f"LT k={k} n={n} {engine} engine on "
            f"{where}: {LT_SIMS} sims, first call {t_first:.2f} s, "
            f"mean symbols needed {float(np.mean(out[0])):.1f}")
    ref = outs[("sparse", "cpu")]
    for key in (("dense", "gpu"), ("sparse", "gpu")):
        same = all((a == b).all() for a, b in zip(outs[key], ref))
        line = (f"LT {key[0]} engine on GPU vs sparse on CPU [int]: "
                f"{'bit-identical' if same else 'DIFFERENT'} "
                f"(result, est, resolved over {LT_SIMS} sims)")
        say("families", line)
        check(same, line)
    return gpu_times


# ----------------------------------------------------------------------
# 6. route timings
# ----------------------------------------------------------------------

def _time_decode(dec, inp) -> tuple:
    """(compile+first seconds, median steady seconds) of one jitted
    decode on the default device."""
    import jax
    import numpy as np

    fn = jax.jit(dec.decode)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(inp))
    first = time.perf_counter() - t0
    times = []
    for _ in range(ROUTE_REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(inp))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times))


def route_cases():
    """(family, code, channel, param, routes, builder(code, perm))."""
    import jax.numpy as jnp

    from ldpc_decoders_tpu.decoders.admm import ADMMDecoder
    from ldpc_decoders_tpu.decoders.bec_spa import BECSPADecoder
    from ldpc_decoders_tpu.decoders.bp import BPDecoder

    reg, bp_routes = "1200_3_6_ldpc", ("incidence", "gather", "matmul")

    def bp(variant, dtype, check_init, policy="reference"):
        return lambda c, perm: BPDecoder(
            c.graph, variant, max_iter=10, msg_dtype=dtype,
            check_init=check_init, inf_policy=policy, perm=perm)

    return [
        ("biAWGN MSA bf16 3 dB", reg, "biawgn", 3.0, bp_routes,
         bp("MSA", jnp.bfloat16, False)),
        ("biAWGN MSA f32 3 dB", reg, "biawgn", 3.0, bp_routes,
         bp("MSA", jnp.float32, False)),
        ("biAWGN SPA-ref bf16 2.5 dB", reg, "biawgn", 2.5, bp_routes,
         bp("SPA", jnp.bfloat16, False)),
        ("biAWGN SPA-ref f32 2.5 dB", reg, "biawgn", 2.5, bp_routes,
         bp("SPA", jnp.float32, False)),
        ("biAWGN SPA-saturate f32 2.5 dB", reg, "biawgn", 2.5, bp_routes,
         bp("SPA", jnp.float32, False, "saturate")),
        ("BSC MSA f32 p=.06", reg, "bsc", 0.06, bp_routes,
         bp("MSA", jnp.float32, True)),
        ("BSC SPA-ref f32 p=.06", reg, "bsc", 0.06, bp_routes,
         bp("SPA", jnp.float32, True)),
        ("margulis biAWGN MSA bf16 2.5 dB", "margulis", "biawgn", 2.5,
         ("incidence", "gather"), bp("MSA", jnp.bfloat16, False)),
        ("margulis biAWGN SPA-ref bf16 2.5 dB", "margulis", "biawgn", 2.5,
         ("incidence", "gather"), bp("SPA", jnp.bfloat16, False)),
        ("BEC ternary SPA eps=.35", reg, "bec", 0.35, ("gather",),
         lambda c, perm: BECSPADecoder(c.graph, max_iter=10)),
        ("biAWGN ADMM cap 50 2.5 dB", reg, "biawgn", 2.5,
         ("gather", "matmul"),
         lambda c, perm: ADMMDecoder(c.graph, max_iter=50, perm=perm)),
        ("margulis BSC ADMM cap 200 p=.06", "margulis", "bsc", 0.06,
         ("gather", "matmul"),
         lambda c, perm: ADMMDecoder(c.graph, max_iter=200, perm=perm)),
    ]


def phase_routes(lt_times: dict) -> None:
    import jax

    from ldpc_decoders_tpu.codes import get_code

    gpu = jax.devices()[0]
    for seed, (family, code_name, channel, param, routes,
               build) in enumerate(route_cases()):
        y, llr = _draw(channel, code_name, param, ROUTE_BATCH, 300 + seed)
        inp = jax.device_put(y if channel == "bec" else llr, gpu)
        code = get_code(code_name)
        best = None
        for perm in routes:
            dec = build(code, perm)
            first, t = _time_decode(dec, inp)
            say("routes", f"{family}, {code_name}, batch {ROUTE_BATCH}, "
                f"route {perm}: {t * 1e3:.2f} ms/decode = "
                f"{ROUTE_BATCH / t:.0f} cw/s (median of {ROUTE_REPS}; "
                f"first call {first:.1f} s)")
            best = min(best or (t, perm), (t, perm))
            del dec
        if len(routes) > 1:
            auto = build(code, "auto").perm
            say("routes", f"{family}: fastest route {best[1]}, "
                f"perm='auto' picks {auto}")
    for engine, t in lt_times.items():
        say("routes", f"LT k={LT_K} n={LT_N} {engine} engine: {LT_SIMS} sims "
            f"in {t:.2f} s = {t / LT_SIMS:.3f} s/sim (second call)")


# ----------------------------------------------------------------------
# four cards
# ----------------------------------------------------------------------

def phase_mesh(chips: int) -> None:
    """Batch mesh == single-device replay exactly, code-sharded margulis
    within the float bar of the single-card decode, LT fan-out (sparse
    and dense engines) == single card exactly (__graft_entry__.dryrun_multichip), at a batch
    that fills the cards and LT at golden scale."""
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(chips, per_device=4096, lt_kn=(10000, 12000),
                     log=lambda line: say("mesh", line))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=[1, 4],
                    help="1: the one-card phases; 4: the mesh phase only")
    args = ap.parse_args(argv)
    phases = select_phases(args.chips)

    from ldpc_decoders_tpu.utils.device import NoGPUError

    t_all = time.perf_counter()
    try:
        info = phase_device(args.chips)
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    lt_times = {}
    for phase in phases[1:]:
        t0 = time.perf_counter()
        if phase == "cli":
            phase_cli()
        elif phase == "campaign":
            phase_campaign()
        elif phase == "lt":
            phase_lt_cli()
        elif phase == "families":
            lt_times = phase_families()
        elif phase == "routes":
            phase_routes(lt_times)
        elif phase == "mesh":
            phase_mesh(args.chips)
        say(phase, f"phase done in {time.perf_counter() - t0:.1f} s")
    say("all", f"total {time.perf_counter() - t_all:.1f} s")
    print(CARD)
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
