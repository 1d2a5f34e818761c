"""Experiment campaigns: the reference's shell-level orchestration
(run_sims.sh + simulations.py + plot_results.py, SURVEY.md 2.23) as a
native case registry.

The reference prints `main.py` argv lines and `eval`s them with `&` for
parallelism across processes/Slurm jobs. Here the parallelism lives
*inside* each run (batched codewords sharded over the mesh), so a
campaign is simply an ordered list of RunConfigs executed in-process.
``--emit`` prints the equivalent CLI lines instead of running, preserving
the reference's print-then-eval contract for external schedulers.

Case registry mirrors reference simulations.py: HMG, MAR, REG_BAD,
REG_ENS, IREG_ENS; plot cases mirror plot_results.py.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Iterator, List

from ldpc_decoders_tpu.harness import MonteCarloRunner, RunConfig
from ldpc_decoders_tpu.utils.registry import Registry

all_cases = Registry()
reg_case = all_cases.reg


def stp(init: float, step: float, count: int) -> List[float]:
    return [init + i * step for i in range(count)]


# Default per-code sweeps (reference simulations.py:27-39).
_BEC_DEF = [.5, .475, .45, .425, .4, .375, .35, .34, .33, .325, .32, .31, .3]
_BSC_MSA = [.081, .0751, .071, .0651, .061, .0551, .051, .0451, .041,
            .0351, .031, .0251, .021, .0151, .01]
_AWGN_MSA = [.5, .75, 1., 1.25, 1.5, 1.75, 2., 2.2, 2.3, 2.4, 2.5, 2.6,
             2.7, 2.8, 2.9, 3.0]
_AWGN_SPA = [.5, .75, 1., 1.25, 1.5, 1.75, 2., 2.25, 2.5, 2.75, 3.]


def def_cases(code: str, mi: int = 10, mw: int = 100) -> Iterator[RunConfig]:
    yield RunConfig("bec", code, "SPA", _BEC_DEF, codeword=0, max_iter=mi,
                    min_wec=mw)
    yield RunConfig("bsc", code, "MSA", _BSC_MSA, codeword=1, max_iter=mi,
                    min_wec=mw)
    yield RunConfig("biawgn", code, "MSA", _AWGN_MSA, codeword=1,
                    max_iter=mi, min_wec=mw)
    yield RunConfig("bsc", code, "SPA", stp(.1, -.01, 7), codeword=0,
                    max_iter=mi, min_wec=mw)
    yield RunConfig("biawgn", code, "SPA", _AWGN_SPA, codeword=0,
                    max_iter=mi, min_wec=mw)


@reg_case
def HMG() -> Iterator[RunConfig]:
    """All Hamming(7,4) sims (reference simulations.py:49-61)."""
    p_bec = [.5, .4, .3, .2, .1, .08, .06, .04, .02]
    p_bsc = p_bec + [.25, .15, .01, .008, .006, .004, .002]
    p_awgn = stp(2, .5, 11)
    code = "7_4_hamming"
    kw = dict(codeword=1, min_wec=300)
    for dec in ["ML", "LP", "SPA", "ADMM"]:
        yield RunConfig("bec", code, dec, p_bec, **kw)
    for dec in ["ML", "LP", "SPA", "MSA", "ADMM"]:
        yield RunConfig("bsc", code, dec, p_bsc, **kw)
    for dec in ["ML", "LP", "SPA", "MSA", "ADMM"]:
        yield RunConfig("biawgn", code, dec, p_awgn, **kw)


@reg_case
def MAR() -> Iterator[RunConfig]:
    """Margulis(2640,1320) ADMM sims (reference simulations.py:63-72)."""
    code = "margulis"
    kw = dict(codeword=1, min_wec=100)
    yield RunConfig("bec", code, "ADMM", _BEC_DEF, **kw)
    yield RunConfig("bsc", code, "ADMM", [.1, .09, .08, .07, .06, .05, .04],
                    **kw)
    yield RunConfig("biawgn", code, "ADMM", _AWGN_SPA, **kw)
    yield from def_cases(code)


@reg_case
def REG_BAD() -> Iterator[RunConfig]:
    """Max-iter sweep on LDPC(1200,3,6) (reference simulations.py:74-77)."""
    yield from def_cases("1200_3_6_ldpc")
    for mi in [0, 1, 2, 3, 6, 40, 100]:
        yield from def_cases("1200_3_6_ldpc", mi)


# Ensemble campaigns: the reference runs these as 10 independent cluster
# jobs per config (simulations.py:79-85); run_campaign instead routes each
# config through ONE EnsembleMonteCarloRunner decoding all members in a
# single compiled program (~members x fewer compiles). The per-member
# generators below remain the --emit contract and the --no-ensemble path.
ENSEMBLE_MEMBERS = {
    "REG_ENS": [f"1200_3_6_rand_ldpc_{i + 1}" for i in range(10)],
    "IREG_ENS": [f"1200_rho_x5_rand_ldpc_{i + 1}" for i in range(10)],
}

# Per-campaign iteration cap for the ensemble routes: the committed IREG
# golden artifacts and the IREG_ENS plot cases are all cap-100 vintage
# (viz/cases.py filters on '-100.json'), so a default `campaign IREG_ENS`
# must write cap-100 files — cap-10 output would be plot-invisible.
# REG_ENS goldens are cap 10 (the def_cases default).
ENSEMBLE_MAX_ITER = {"IREG_ENS": 100}

# REG_BAD's iteration-cap grid (reference simulations.py:74-77) likewise
# collapses: CapSweepRunner tallies every cap from one decode pass, so
# the 8-cap x 5-sweep grid costs 5 compilations, not 40 jobs.
CAP_SWEEP_CASES = {
    "REG_BAD": ("1200_3_6_ldpc", [0, 1, 2, 3, 6, 10, 40, 100]),
}


@reg_case
def REG_ENS() -> Iterator[RunConfig]:
    for name in ENSEMBLE_MEMBERS["REG_ENS"]:
        yield from def_cases(name)


@reg_case
def IREG_ENS() -> Iterator[RunConfig]:
    for name in ENSEMBLE_MEMBERS["IREG_ENS"]:
        yield from def_cases(name, ENSEMBLE_MAX_ITER["IREG_ENS"])


# ----------------------------------------------------------------------
# Execution
# ----------------------------------------------------------------------

def to_argv(cfg: RunConfig) -> str:
    """Equivalent `python -m ldpc_decoders_tpu.main` line (the reference's
    simulations.py print contract, for external schedulers)."""
    parts = [cfg.channel, cfg.code, cfg.decoder,
             "--codeword=%d" % cfg.codeword,
             "--max-iter=%d" % cfg.max_iter,
             "--min-wec=%d" % cfg.min_wec,
             "--params " + " ".join("%g" % p for p in cfg.params)]
    return " ".join(parts)


def run_campaign(case_names, data_dir=None, mesh=None, overrides=None,
                 use_ensemble=True, joint_ensemble=False):
    results = {}
    for name in case_names:
        if use_ensemble and name in ENSEMBLE_MEMBERS and joint_ensemble:
            from ldpc_decoders_tpu.harness.ensemble_runner import (
                EnsembleMonteCarloRunner,
            )
            members = ENSEMBLE_MEMBERS[name]
            mi = ENSEMBLE_MAX_ITER.get(name)
            for cfg in (def_cases(name, mi) if mi else def_cases(name)):
                # G=10 members decode at once: per-member batch 2048 keeps
                # the stacked tables + message buffers inside one device's
                # memory (override with --batch). biAWGN sweeps run
                # bfloat16 messages (statistically validated vs the
                # golden curves, docs/PARITY.md); BSC stays float32 — its LLRs are all equal multiples of
                # log((1-p)/p) and that tie structure is NOT bf16-safe
                # (the committed member goldens were regenerated in f32,
                # scripts/regen_ens_cross.py). BEC's integer messages are
                # exact at fast precision by construction.
                cfg = dataclasses.replace(
                    cfg, batch=2048,
                    msg_dtype=("bfloat16" if cfg.channel == "biawgn"
                               else "float32"))
                if data_dir:
                    cfg = dataclasses.replace(cfg, data_dir=data_dir)
                if overrides:
                    cfg = dataclasses.replace(cfg, **overrides)
                runner = EnsembleMonteCarloRunner(cfg, members, mesh=mesh)
                results[(name, f"ensemble:{to_argv(cfg)}")] = runner.run()
            continue
        if use_ensemble and name in ENSEMBLE_MEMBERS:
            # Default ensemble route: ONE compiled chunk, members rotated
            # through it as traced tables (runner.rotate_member), so each
            # member decodes at single-code rate; --joint-ensemble
            # selects the G-stacked program instead.
            from ldpc_decoders_tpu.harness.runner import (
                run_rotating_members,
            )
            members = ENSEMBLE_MEMBERS[name]
            mi = ENSEMBLE_MAX_ITER.get(name)
            for cfg in (def_cases(name, mi) if mi else def_cases(name)):
                # Same precision policy as the joint route above: bf16
                # only on biAWGN (BSC tie structure is not bf16-safe).
                cfg = dataclasses.replace(
                    cfg,
                    msg_dtype=("bfloat16" if cfg.channel == "biawgn"
                               else "float32"))
                if data_dir:
                    cfg = dataclasses.replace(cfg, data_dir=data_dir)
                if overrides:
                    cfg = dataclasses.replace(cfg, **overrides)
                results[(name, f"rotating:{to_argv(cfg)}")] = \
                    run_rotating_members(cfg, members, mesh=mesh)
            continue
        if use_ensemble and name in CAP_SWEEP_CASES:
            from ldpc_decoders_tpu.harness.cap_sweep import CapSweepRunner
            code, caps = CAP_SWEEP_CASES[name]
            for cfg in def_cases(code):
                # Long mi=0 convergence chains run every chunk to its
                # slowest word: a smaller batch keeps each chunk short.
                cfg = dataclasses.replace(cfg, batch=2048)
                if data_dir:
                    cfg = dataclasses.replace(cfg, data_dir=data_dir)
                if overrides:
                    cfg = dataclasses.replace(cfg, **overrides)
                runner = CapSweepRunner(cfg, caps)
                results[(name, f"caps:{to_argv(cfg)}")] = runner.run()
            continue
        for cfg in all_cases.get(name)():
            if data_dir:
                cfg = dataclasses.replace(cfg, data_dir=data_dir)
            if overrides:
                cfg = dataclasses.replace(cfg, **overrides)
            results[(name, to_argv(cfg))] = MonteCarloRunner(
                cfg, mesh=mesh).run()
    return results


def main(argv=None):
    import logging

    p = argparse.ArgumentParser(description="run experiment campaigns")
    p.add_argument("case", nargs="+", choices=all_cases.keys())
    p.add_argument("--emit", action="store_true",
                   help="print CLI lines instead of running")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--min-wec", dest="min_wec", type=int, default=None)
    p.add_argument("--max-words", dest="max_words", type=int, default=None,
                   help="stop each sweep point after this many words")
    p.add_argument("--no-ensemble", dest="no_ensemble", action="store_true",
                   help="run ensemble cases per member (reference-style)")
    p.add_argument("--joint-ensemble", dest="joint_ensemble",
                   action="store_true",
                   help="decode all members in one G-stacked program "
                        "instead of rotating them through one compiled "
                        "chunk")
    args = p.parse_args(argv)
    logging.basicConfig(format="%(name)s|%(message)s", level=logging.INFO)

    if args.emit:
        for name in args.case:
            for cfg in all_cases.get(name)():
                print(to_argv(cfg), flush=True)
        return

    overrides = {}
    if args.batch:
        overrides["batch"] = args.batch
    if args.min_wec:
        overrides["min_wec"] = args.min_wec
    if args.max_words:
        overrides["max_words"] = args.max_words
    run_campaign(args.case, data_dir=args.data_dir, overrides=overrides,
                 use_ensemble=not args.no_ensemble,
                 joint_ensemble=args.joint_ensemble)


if __name__ == "__main__":
    main()
