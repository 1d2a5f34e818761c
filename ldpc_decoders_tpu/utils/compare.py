"""Agreement bars between two decodes of the same inputs.

Integer dynamics (ternary BEC SPA, LT peeling, ML on BSC/BEC) must agree
bit for bit. Float routes differ legitimately in the summation order of
per-variable marginals, which flips the odd exact tie at deep-tie BSC
operating points: a few words per thousand change their iteration count
and the occasional already-errored word its (wrong) decision. The bar
they are held to (pinned by
tests/test_decoders_oracle.py::test_bp_f32_routes_tie_jitter_bound) is
at most 1% of words with differing decisions and at most 3% with
differing iteration counts.
"""

from __future__ import annotations

import numpy as np

DEC_WORD_FRAC = 0.01
ITER_WORD_FRAC = 0.03
# A regenerated curve against its committed golden: 5 Agresti-Coull
# standard errors plus 0.01 absolute (the goldens stop near 100-300
# errors, and committed points sit up to a few sigma from float64 truth).
GOLDEN_SIGMA = 5.0
GOLDEN_SLACK = 0.01


def mismatch_counts(x_a, it_a, x_b, it_b) -> tuple:
    """(words whose decisions differ, words whose iteration counts
    differ). ``x_*`` are [B, V] decisions; ``it_*`` are [B] counts or
    None (decoders that report none)."""
    x_a, x_b = np.asarray(x_a), np.asarray(x_b)
    if x_a.shape != x_b.shape:
        raise ValueError(f"shape mismatch {x_a.shape} vs {x_b.shape}")
    dec = int((x_a != x_b).reshape(x_a.shape[0], -1).any(axis=1).sum())
    it = 0
    if it_a is not None:
        it = int((np.asarray(it_a) != np.asarray(it_b)).sum())
    return dec, it


def within_float_bar(dec_mism: int, it_mism: int, n_words: int) -> bool:
    """The float-route bar: decisions differ in at most 1% of words and
    iteration counts in at most 3%."""
    return (dec_mism <= DEC_WORD_FRAC * n_words
            and it_mism <= ITER_WORD_FRAC * n_words)


def ac_var(wer: float, n: int) -> float:
    """Agresti-Coull adjusted binomial variance of an observed rate: two
    pseudo successes and two pseudo failures keep it honest at WER 0 or
    1, where the raw estimate degenerates to 0."""
    p = (wer * n + 2.0) / (n + 4.0)
    return p * (1.0 - p) / (n + 4.0)


def golden_allowance(wer: float, n: int, g_wer: float, g_n: int) -> float:
    """How far a curve point may sit from its golden point: GOLDEN_SIGMA
    Agresti-Coull standard errors of the difference plus GOLDEN_SLACK."""
    return GOLDEN_SIGMA * float(np.sqrt(ac_var(wer, n) + ac_var(g_wer, g_n))
                                ) + GOLDEN_SLACK


def wer_sigma_gap(wer_a: float, n_a: int, wer_b: float, n_b: int) -> float:
    """|wer_a - wer_b| in units of the standard error of their difference
    under equal rates (the two-proportion z statistic: the variance comes
    from the pooled rate, so a point with no errors against a rare-error
    curve is not held to the other side's tiny variance alone). 0 when
    both estimates are exact 0 or 1."""
    pooled = (wer_a * n_a + wer_b * n_b) / (n_a + n_b)
    var = pooled * (1 - pooled) * (1 / n_a + 1 / n_b)
    gap = abs(wer_a - wer_b)
    if var <= 0:
        return 0.0 if gap == 0 else float("inf")
    return gap / float(np.sqrt(var))
