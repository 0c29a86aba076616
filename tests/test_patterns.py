"""CompiledPattern — AOT-compiled, reusable match circuits (models/)."""

import numpy as np
import pytest

from fhe_regex_tpu import decrypt, trivial_encrypt_str
from fhe_regex_tpu.models.patterns import BASELINE_CONFIGS, CompiledPattern
from fhe_regex_tpu.ops.pbs import prepare_server_key
from fhe_regex_tpu.params import TEST_PARAMS
from fhe_regex_tpu.regex.engine import BranchBudgetExceeded
from fhe_regex_tpu.regex.executor import Executor
from fhe_regex_tpu.regex import native


def test_compiled_pattern_reuse_across_contents(keys):
    ck, sk = keys
    prog = CompiledPattern("/ab?c/", params=TEST_PARAMS)
    ex = Executor(TEST_PARAMS, prepare_server_key(TEST_PARAMS, sk, "jnp"))
    for content, want in [("abc", 1), ("ac", 1), ("adc", 0), ("xabcx", 1)]:
        ct = trivial_encrypt_str(TEST_PARAMS, content)
        assert decrypt(ck, prog.match(ex, ct)) == want, content
    # circuit cached per content length
    assert set(prog._circuits) == {3, 2, 5}
    stats = prog.stats(3)
    assert stats["bootstraps"] > 0 and stats["levels"] > 0


@pytest.mark.parametrize("engine", ["python"] + (["native"] if native.available() else []))
def test_compiled_pattern_engines_agree(engine, keys):
    prog = CompiledPattern("/^a[b-d]{2,4}e$/i", params=TEST_PARAMS,
                           engine=engine)
    s = prog.stats(5)
    ref = CompiledPattern("/^a[b-d]{2,4}e$/i", params=TEST_PARAMS,
                          engine="python").stats(5)
    assert s == ref


def test_compiled_pattern_budget():
    with pytest.raises(BranchBudgetExceeded):
        CompiledPattern("/a*bc/", params=TEST_PARAMS,
                        branch_budget=1).circuit(6)


def test_driver_configs_parse():
    for cfg in BASELINE_CONFIGS:
        CompiledPattern(cfg["pattern"], params=TEST_PARAMS)
