"""Pin the bench.py contract: one JSON line per metric on stdout, each
naming the device it ran on; no accelerator and no --rehearse is a
failure, not a CPU fallback."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _check_record(line: str, metric: str) -> dict:
    rec = json.loads(line)
    assert rec["metric"] == metric
    assert rec["unit"] == "bootstraps/s"
    assert rec["value"] > 0
    assert abs(rec["vs_baseline"] - rec["value"] / 100.0) < 0.01
    for key in ("platform", "device_kind", "device_count", "card",
                "backend", "batch", "params"):
        assert key in rec, key
    return rec


def _run(tmp_path, *args, **env_extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_ITERS="1",
               BENCH_BATCH="8",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jaxcache"),
               **env_extra)
    return subprocess.run([sys.executable, str(REPO / "bench.py"), *args],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)


def test_bench_json_contract(tmp_path):
    out = _run(tmp_path, "--rehearse")
    assert out.returncode == 0, out.stderr[-800:]
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    assert len(lines) == 2, out.stdout
    rec = _check_record(lines[0], "pbs_per_sec_per_chip")
    assert rec["platform"] == "cpu" and rec["params"] == "TEST_PARAMS"
    ref = _check_record(lines[1], "pbs_per_sec_per_chip_ref64")
    assert ref["params"] == "TEST_PARAMS_64" and ref["backend"] == "jnp64"


def test_bench_refuses_cpu_without_rehearse(tmp_path):
    out = _run(tmp_path, BENCH_REF64="0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no accelerator" in out.stderr
