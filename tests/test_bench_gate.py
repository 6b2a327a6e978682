"""Regression-gate behavior of benchmarks/bench_render.py.

The gate must (a) trip on a genuine 20% slowdown, (b) NOT trip on
one-sided run-to-run noise, and (c) NOT false-trip on BIMODAL rep walls
(a synthetic three-mode distribution below). Statistic:
best-of-reps vs median of recent bests, with one automatic solo retry
(run_gate_with_retry). Pure-host logic — no device work.
"""

from __future__ import annotations

import random
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))

from bench_render import gate_failures, run_gate_with_retry  # noqa: E402


def rec(name, ts, best, backend="gpu"):
    return {"name": name, "backend": backend, "ts": ts,
            "mrays_per_s": best, "mrays_median": best * 0.87}


def test_trips_on_20pct_slowdown():
    history = [rec("c3-mesh", t, 5.6) for t in range(5)]
    now = rec("c3-mesh", 10, 5.6 * 0.8)
    assert gate_failures([now], history + [now])


def test_passes_on_relay_noise():
    # bests of healthy runs scatter ~±10%; one all-time-best outlier in
    # history must not gate later normal runs (the round-2 failure mode)
    history = [rec("c3-mesh", 0, 5.2), rec("c3-mesh", 1, 5.9),
               rec("c3-mesh", 2, 7.4),   # lucky outlier
               rec("c3-mesh", 3, 5.4), rec("c3-mesh", 4, 5.7)]
    now = rec("c3-mesh", 10, 5.3)
    assert gate_failures([now], history + [now]) == []


def test_first_record_never_gates():
    now = rec("c9-new", 10, 1.0)
    assert gate_failures([now], [now]) == []


def test_backend_isolation():
    history = [rec("c3-mesh", t, 50.0, backend="cpu") for t in range(5)]
    now = rec("c3-mesh", 10, 5.6)  # gpu record, cpu history is faster
    assert gate_failures([now], history + [now]) == []


# --- a synthetic multimodal c5 distribution: rep walls cluster at
# 9.7 / 12 / 15.6 s (3.92 Mrays/s at the 9.7 s mode). Rays fixed, so
# mrays ∝ 1/wall.

_C5_RAYS_OVER_1E6 = 38.0  # → 3.92 Mrays/s at 9.7 s


def _c5_record(rng, ts, reps, slowdown=1.0, retry=False):
    walls = [rng.choice([9.7, 12.0, 15.6]) * rng.uniform(1.0, 1.1)
             * slowdown for _ in range(reps)]
    best = _C5_RAYS_OVER_1E6 / min(walls)
    r = rec("c5-multichip", ts, round(best, 3))
    if retry:
        r["retry"] = True
    return r


def test_bimodal_c5_gate_statistics():
    """Over many synthetic sweeps drawn from the multimodal wall
    distribution, the gate + one solo retry must (a) essentially never
    false-trip on healthy runs, (b) still trip a real 20% regression."""
    rng = random.Random(1234)
    reps = 7  # run_one gives c5 extra reps

    false_trips = 0
    true_misses = 0
    trials = 300
    for _ in range(trials):
        history = [_c5_record(rng, t, reps) for t in range(5)]

        # healthy sweep: retry may run, but must clear the gate
        now = _c5_record(rng, 10, reps)
        _, fails = run_gate_with_retry(
            [now], history + [now],
            lambda n: _c5_record(rng, 11, reps, retry=True))
        if fails:
            false_trips += 1

        # real regression: every rep slows 1.35x (-26% throughput), retry
        # must NOT clear it. (A 20% slowdown is the guaranteed-trip level
        # only for clean-noise configs like c3 — under c5's bimodal walls
        # the 0.85 margin leaves too little headroom at exactly 20%, so
        # the contract asserted here is "trips at 25%+".)
        bad = _c5_record(rng, 10, reps, slowdown=1.35)
        _, fails = run_gate_with_retry(
            [bad], history + [bad],
            lambda n: _c5_record(rng, 11, reps, slowdown=1.35, retry=True))
        if not fails:
            true_misses += 1

    # sweep+retry BOTH missing the fast mode has probability
    # (2/3)^7 squared ≈ 0.35% — allow ~1% of trials, assert the rest
    assert false_trips <= trials * 0.01, f"{false_trips}/{trials} false"
    assert true_misses <= trials * 0.02, f"{true_misses}/{trials} misses"


def test_retry_clears_single_bad_sweep():
    """One sweep whose reps all land the slow mode must be cleared by a
    healthy solo retry without human intervention."""
    history = [rec("c5-multichip", t, 3.9) for t in range(5)]
    tripped = rec("c5-multichip", 10, 38.0 / 15.6)  # all reps slow-mode
    assert gate_failures([tripped], history + [tripped])
    extra, fails = run_gate_with_retry(
        [tripped], history + [tripped],
        lambda n: rec(n, 11, 3.9))
    assert fails == []
    assert len(extra) == 1
