"""One shared compile-cache rule for every entry point
(fhe_regex_tpu/utils/compile_cache.py): JAX_COMPILATION_CACHE_DIR when it
is set, else the fixed <repo>/.cache/jax — never a per-run path."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PROBE = ("from fhe_regex_tpu.utils.compile_cache import enable_compile_cache;"
         "import jax; print(enable_compile_cache());"
         "print(jax.config.jax_compilation_cache_dir)")


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-800:]
    return out.stdout.split()


def test_cache_dir_from_the_environment_wins(tmp_path):
    d = str(tmp_path / "jaxcache")
    returned, configured = _probe(d)
    assert returned == d and configured == d


def test_cache_dir_defaults_to_the_repo(tmp_path):
    returned, configured = _probe(None)
    want = str(REPO / ".cache" / "jax")
    assert returned == want and configured == want


ENTRY_POINTS = (["fhe_regex_tpu/cli.py", "fhe_regex_tpu/serve.py",
                 "bench.py", "chip_smoke.py"]
                + sorted(str(p.relative_to(REPO))
                         for p in (REPO / "benchmarks").glob("*.py")
                         if p.name != "cpu_baseline.py"))


@pytest.mark.parametrize("path", ENTRY_POINTS)
def test_entry_point_uses_the_shared_helper(path):
    """Each entry point calls the helper and sets no cache path itself."""
    src = (REPO / path).read_text()
    assert "enable_compile_cache()" in src
    assert "JAX_COMPILATION_CACHE_DIR" not in src
    assert "jax_compilation_cache_dir" not in src
