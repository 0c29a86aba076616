"""chip_smoke.py's phases at test sizes on the CPU, and its refusal to run
without a GPU or outside a checkout.  The full-size run happens on the
card (README: "Running on the GPU")."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fhe_regex_tpu.params import TEST_PARAMS, TEST_PARAMS_64, TEST_PARAMS_NOISY

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def smoke_keys():
    return cs.Keys(0)


def test_routes_phase_bitexact_and_timed(smoke_keys):
    rep = cs.phase_routes(smoke_keys, TEST_PARAMS_NOISY, TEST_PARAMS_64,
                          None, [8, 16])
    rows = rep["routes"]
    assert not rep["errors"]
    labels = {(r["route"], r["B"]) for r in rows}
    for route in ("jnp", "int8"):
        assert {(route, 8), (route, 16)} <= labels, route
    assert ("jnp64", 8) in labels
    by = {(r["route"], r["B"]): r for r in rows}
    assert by[("jnp", 8)]["bitexact_vs_golden"] is True
    assert by[("int8", 8)]["bitexact_vs_golden"] is True
    assert by[("int8", 16)]["bitexact_vs_jnp"] is True
    assert by[("jnp64", 8)]["bitexact_vs_golden"] is True
    assert all(r["wrong"] == 0 for r in rows if "wrong" in r)
    assert rep["key_bytes"] > 0


def test_match_phase_checks_the_oracle(smoke_keys):
    rep = cs.phase_match(smoke_keys, TEST_PARAMS_NOISY, cs._configs(
        ["exact_literal", "case_insensitive_classes", "north_star_64"]))
    assert [r["got"] for r in rep["configs"]] == [
        r["want"] for r in rep["configs"]]
    assert len(rep["configs"]) == 3


def test_match_phase_fails_on_a_wrong_answer(smoke_keys, monkeypatch):
    monkeypatch.setattr("fhe_regex_tpu.regex.oracle.oracle_match",
                        lambda content, pattern: 7)
    with pytest.raises(cs.PhaseFailure, match="wrong results"):
        cs.phase_match(smoke_keys, TEST_PARAMS_NOISY,
                       cs._configs(["exact_literal"]))


def test_serve_phase_over_http(smoke_keys):
    rep = cs.phase_serve(smoke_keys, TEST_PARAMS, long_len=64, long_window=16)
    endpoints = [r["endpoint"] for r in rep["requests"]]
    assert endpoints == ["/match", "/match", "/match_many", "/match_long"]
    assert all(r["got"] == r["want"] for r in rep["requests"])


def test_multi_phase_on_four_virtual_devices(smoke_keys):
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices (tests/conftest.py forces 8 virtual "
                    "CPU devices)")
    rep = cs.phase_multi(smoke_keys, TEST_PARAMS, 4, B=16)
    assert rep["level"]["bit_equal"] and rep["has_match"]["bit_equal"]
    assert rep["or_tree"]["ors"] == [1, 1, 1, 1]


def _run_smoke(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300, env=env, cwd=cwd)


def test_exits_nonzero_without_a_gpu():
    out = _run_smoke(REPO / "chip_smoke.py", REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
