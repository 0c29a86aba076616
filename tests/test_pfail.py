"""Failure-probability contract (VERDICT r3 missing #3) + unsafe-set guard.

Modern TFHE deployments state correctness as a per-bootstrap failure
probability; ``noise_budget_report`` now derives it from the sigma margin
(two-sided Gaussian tail) and ``Params.p_fail_circuit`` gives the per-run
union bound.  Both production sets must clear p_fail <= 2^-40 per PBS;
the reference-era set's ~2.1-sigma (~3%/op) point is pinned as documented,
and selecting it with real noise now warns at keygen/executor time.
"""

import dataclasses
import math
import warnings

import numpy as np
import pytest

from fhe_regex_tpu.params import (
    MIN_SIGMA_MARGIN,
    REF_MESSAGE_2_CARRY_2_64,
    TEST_PARAMS,
    TPU64_MESSAGE_2_CARRY_2,
    TPU_MESSAGE_2_CARRY_2,
    log2_p_fail_sigma,
    p_fail_sigma,
    warn_if_unsafe,
)


def test_production_sets_meet_2e40_per_pbs():
    for p in (TPU_MESSAGE_2_CARRY_2, TPU64_MESSAGE_2_CARRY_2):
        rep = p.noise_budget_report()
        assert rep["log2_p_fail_per_pbs"] <= -40.0, (p.name, rep)
        # and a realistic large serving circuit stays tiny end-to-end
        assert p.p_fail_circuit(10_000) < 2.0 ** -25, p.name


def test_ref64_pfail_matches_the_2sigma_analysis():
    """tfhe-rs 0.2's own operating point: ~2 sigma, a few % per op
    (params.py:236-250 analysis, pinned by test_torus64)."""
    rep = REF_MESSAGE_2_CARRY_2_64.noise_budget_report()
    assert 1.5 < rep["sigma_margin"] < 3.0
    assert 0.005 < rep["p_fail_per_pbs"] < 0.10
    # at that rate a 100-bootstrap circuit is near-certain to wobble —
    # the honest statement of why the set is bench/parity-only
    assert REF_MESSAGE_2_CARRY_2_64.p_fail_circuit(100) > 0.5


def test_tail_helpers_are_consistent_and_stable():
    # erfc region: log2 helper agrees with direct computation
    for k in (1.0, 3.0, 8.0, 20.0):
        direct = math.log2(p_fail_sigma(k))
        assert abs(log2_p_fail_sigma(k) - direct) < 1e-6
    # past f64 underflow (k ~ 40+): asymptotic expansion takes over smoothly
    assert p_fail_sigma(60.0) == 0.0
    assert -2610 < log2_p_fail_sigma(60.0) < -2580
    # monotone decreasing
    ks = [1.0, 2.0, 5.0, 7.0, 10.0, 40.0, 60.0]
    vals = [log2_p_fail_sigma(k) for k in ks]
    assert vals == sorted(vals, reverse=True)


def test_p_fail_circuit_union_bound():
    p = TPU_MESSAGE_2_CARRY_2
    one = p.noise_budget_report()["p_fail_per_pbs"]
    assert p.p_fail_circuit(1) == pytest.approx(one)
    assert p.p_fail_circuit(1000) == pytest.approx(1000 * one, rel=1e-6)
    # the bound saturates at 1 for hopeless sets rather than overflowing
    assert REF_MESSAGE_2_CARRY_2_64.p_fail_circuit(10_000) <= 1.0


def test_compiled_pattern_stats_surface_the_contract():
    from fhe_regex_tpu.models.patterns import CompiledPattern

    prog = CompiledPattern("/ab/", params=TEST_PARAMS)
    st = prog.stats(4)
    assert "p_fail_circuit" in st and "log2_p_fail_per_pbs" in st
    assert 0.0 <= st["p_fail_circuit"] <= 1.0


def test_unsafe_set_warns_once_at_keygen(monkeypatch):
    from fhe_regex_tpu import params as P
    from fhe_regex_tpu.crypto.keys import gen_keys

    unsafe = dataclasses.replace(
        TEST_PARAMS, name="UNSAFE_TEST_SET",
        lwe_noise_std=float(TEST_PARAMS.delta),  # noise ~ the decision margin
        glwe_noise_std=1.0)
    assert unsafe.noise_budget_report()["sigma_margin"] < MIN_SIGMA_MARGIN
    monkeypatch.delenv("FHE_REGEX_ALLOW_UNSAFE", raising=False)
    monkeypatch.setattr(P, "_unsafe_warned", set())
    with pytest.warns(UserWarning, match="UNSAFE_TEST_SET.*sigma"):
        gen_keys(unsafe, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # second call: silent (one-time)
        gen_keys(unsafe, seed=2)


def test_unsafe_warning_optout(monkeypatch):
    from fhe_regex_tpu import params as P

    unsafe = dataclasses.replace(
        TEST_PARAMS, name="UNSAFE_TEST_SET2",
        lwe_noise_std=float(TEST_PARAMS.delta), glwe_noise_std=1.0)
    monkeypatch.setenv("FHE_REGEX_ALLOW_UNSAFE", "1")
    monkeypatch.setattr(P, "_unsafe_warned", set())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warn_if_unsafe(unsafe, "test")


def test_zero_noise_test_sets_never_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warn_if_unsafe(TEST_PARAMS, "test")
