"""Dispatch watchdog: an anomalous launch (here an artificial 1694-s
stall) must self-diagnose.  Unit tests on the EMA detector plus the
integration fact that Executor.run feeds it."""

import logging

import numpy as np
import pytest

from fhe_regex_tpu.utils.watchdog import LaunchWatchdog


def test_warmup_observations_never_alarm():
    wd = LaunchWatchdog(ratio=10.0, floor_seconds=5.0, warmup=1)
    # cold compile: 1800 s — expected, discarded entirely
    assert wd.observe(("fused", 1000, 50, False), 1800.0) is None
    # first warm run: held as a pending seed, no alarm yet
    assert wd.observe(("fused", 1000, 50, False), 4.0) is None


def test_anomaly_fires_and_does_not_poison_the_ema():
    wd = LaunchWatchdog(ratio=10.0, floor_seconds=5.0, warmup=0)
    key = ("fused", 1000, 50, False)
    assert wd.observe(key, 4.0) is None          # pending seed
    assert wd.observe(key, 4.2) is None          # EMA seeds at min = 4.0
    w = wd.observe(key, 1694.0)                  # the artificial stall
    assert w is not None and "anomalous launch" in w and "1694.0s" in w
    # the stall did NOT enter the EMA: a second stall still fires
    assert wd.observe(key, 1694.0) is not None
    # and normal runs resume silently
    assert wd.observe(key, 4.1) is None


def test_stall_on_the_first_warm_run_is_caught_retroactively():
    """The round-3 anomaly's own shape: the very first warm observation
    is the stall.  Min-of-two seeding exposes it once the second
    observation reveals the true baseline (advisor round 4 — a naive
    first-observation seed would silently absorb it)."""
    wd = LaunchWatchdog(ratio=10.0, floor_seconds=5.0, warmup=1)
    key = ("fused", 1000, 50, False)
    assert wd.observe(key, 1800.0) is None       # cold compile, discarded
    assert wd.observe(key, 1694.0) is None       # stall, held as pending
    w = wd.observe(key, 4.1)                     # truth arrives
    assert w is not None and "1694.0s" in w
    assert wd._ema[key] == pytest.approx(4.1)    # seeded from the min


def test_floor_suppresses_cheap_launch_noise():
    wd = LaunchWatchdog(ratio=10.0, floor_seconds=5.0, warmup=0)
    key = ("levels", 10, 20, False)
    assert wd.observe(key, 0.01) is None
    # 100x blowup but under the absolute floor: no alarm
    assert wd.observe(key, 1.0) is None
    assert wd.observe(key, 1.0) is None


def test_warning_is_logged(caplog):
    wd = LaunchWatchdog(ratio=10.0, floor_seconds=5.0, warmup=0)
    key = ("fused", 1, 2, True)
    wd.observe(key, 1.0)
    with caplog.at_level(logging.WARNING, logger="fhe_regex_tpu.watchdog"):
        wd.observe(key, 100.0)
    assert any("anomalous launch" in r.message for r in caplog.records)


def test_snapshot_is_a_copy():
    wd = LaunchWatchdog(warmup=0)
    wd.observe(("a",), 1.0)
    wd.observe(("a",), 1.2)
    snap = wd.snapshot()
    assert snap == {"('a',)": 1.0}
    snap["x"] = 9
    assert "x" not in wd.snapshot()


def test_executor_feeds_the_watchdog(keys):
    """An Executor.run updates the per-shape counters (integration smoke)."""
    from fhe_regex_tpu import compile_circuit, executor_for, trivial_encrypt_str
    from fhe_regex_tpu.params import TEST_PARAMS
    from fhe_regex_tpu.regex.engine import compile_match

    ck, sk = keys
    ex = executor_for(sk)
    b, r = compile_match(3, "/ab/")
    circ = compile_circuit(TEST_PARAMS, b, r)
    ex.watchdog._seen.clear(); ex.watchdog._ema.clear()
    ex.watchdog._first.clear()
    ex.run(circ, trivial_encrypt_str(TEST_PARAMS, "abc"))
    ex.run(circ, trivial_encrypt_str(TEST_PARAMS, "abc"))
    assert len(ex.watchdog._seen) == 1
    key = next(iter(ex.watchdog._seen))
    assert ex.watchdog._seen[key] == 2 and key[1] == circ.pbs_count
