"""Randomized semantic-oracle fuzzing: encrypted pipeline vs plaintext truth.

An independent *plaintext* evaluator of the reference dialect semantics
(fhe_regex_tpu/regex/oracle.py) computes the expected 0/1 by direct
boolean evaluation — no circuit builder, LUTs, executor, or PBS involved.
Random patterns (generator shared with test_native_fuzz) and contents are
then run through the FULL encrypted path (compile -> level-scheduled batched
PBS -> decrypt) in both fold modes and the result must equal the oracle.
"""

import random

import pytest

from fhe_regex_tpu import decrypt, has_match, trivial_encrypt_str
from fhe_regex_tpu.params import TEST_PARAMS
from fhe_regex_tpu.regex.oracle import OracleBudgetExceeded, oracle_match
from fhe_regex_tpu.regex.parser import parse

from test_native_fuzz import _pattern


def _content(rng) -> str:
    return "".join(rng.choice("abcdexyz") for _ in range(rng.randint(0, 6)))


@pytest.mark.parametrize("seed", range(60))
def test_fuzz_encrypted_vs_oracle(seed, keys):
    ck, sk = keys
    rng = random.Random(1000 + seed)
    pattern = _pattern(rng)
    content = _content(rng)
    try:
        parse(pattern)
    except ValueError:
        pytest.skip(f"generator produced unparsable {pattern!r}")
    try:
        want = oracle_match(content, pattern)
    except (ValueError, OracleBudgetExceeded, RecursionError):
        pytest.skip(f"pattern {pattern!r} not executable / too wide")
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    for fold in ("reference", "tree"):
        try:
            res = has_match(sk, ct, pattern, backend="jnp", fold=fold,
                            branch_budget=200_000)
        except Exception as e:       # budget parity with the oracle guard
            pytest.skip(f"{pattern!r}: {type(e).__name__}")
        got = decrypt(ck, res)
        assert got == want, (pattern, content, fold)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_noisy_encrypted_vs_oracle(seed, noisy_keys):
    """Same oracle check through REAL (noisy) encryption — validates the
    noise path end-to-end, not just the trivial-ciphertext logic."""
    from fhe_regex_tpu import encrypt_str

    ck, sk = noisy_keys
    rng = random.Random(7000 + seed)
    pattern = _pattern(rng)
    content = _content(rng)
    try:
        parse(pattern)
    except ValueError:
        pytest.skip(f"generator produced unparsable {pattern!r}")
    try:
        want = oracle_match(content, pattern)
    except (ValueError, OracleBudgetExceeded, RecursionError):
        pytest.skip(f"pattern {pattern!r} not executable / too wide")
    ct = encrypt_str(ck, content)
    try:
        res = has_match(sk, ct, pattern, backend="jnp", fold="tree",
                        branch_budget=200_000)
    except Exception as e:
        pytest.skip(f"{pattern!r}: {type(e).__name__}")
    assert decrypt(ck, res) == want, (pattern, content)


@pytest.mark.parametrize("seed", range(20))
@pytest.mark.parametrize("engine", ["python", "native"])
def test_fuzz_multipattern_vs_oracle(seed, engine, keys):
    """Random pattern SETS through the shared multi-root circuit: every
    root must decrypt to its own pattern's oracle bit (cross-pattern
    hash-consing must never couple results)."""
    from fhe_regex_tpu import has_match_patterns
    from fhe_regex_tpu.regex import native

    if engine == "native" and not native.available():
        pytest.skip("native lib not built")
    ck, sk = keys
    rng = random.Random(3000 + seed)
    content = _content(rng)
    patterns, wants = [], []
    while len(patterns) < 4:
        pattern = _pattern(rng)
        try:
            parse(pattern)
            wants.append(oracle_match(content, pattern))
        except (ValueError, OracleBudgetExceeded, RecursionError):
            continue
        patterns.append(pattern)
    try:
        res = has_match_patterns(sk, trivial_encrypt_str(TEST_PARAMS, content),
                                 patterns, backend="jnp", engine=engine,
                                 branch_budget=200_000)
    except Exception as e:           # budget parity with the oracle guard
        pytest.skip(f"{patterns!r}: {type(e).__name__}")
    got = [decrypt(ck, res[i]) for i in range(len(patterns))]
    assert got == wants, (patterns, content)


@pytest.mark.parametrize("seed", range(20))
def test_fuzz_multivalue_vs_oracle(seed, keys):
    """Random patterns through the shared-rotation (multi-value) executor
    must match the plaintext oracle exactly."""
    ck, sk = keys
    rng = random.Random(5000 + seed)
    pattern = _pattern(rng)
    content = _content(rng)
    try:
        parse(pattern)
        want = oracle_match(content, pattern)
    except (ValueError, OracleBudgetExceeded, RecursionError):
        pytest.skip(f"{pattern!r} not executable / too wide")
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    try:
        res = has_match(sk, ct, pattern, backend="jnp", fold="tree",
                        branch_budget=200_000, multivalue=True)
    except Exception as e:
        pytest.skip(f"{pattern!r}: {type(e).__name__}")
    assert decrypt(ck, res) == want, (pattern, content)


@pytest.fixture(scope="module")
def keys64_fuzz():
    from fhe_regex_tpu.crypto.keys import gen_keys
    from fhe_regex_tpu.params import TEST_PARAMS_64
    return gen_keys(TEST_PARAMS_64, seed=21)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_64bit_vs_oracle(seed, keys64_fuzz):
    """Random patterns through the 64-bit limb-pair pipeline (classic and
    multi-value) must match the plaintext oracle."""
    from fhe_regex_tpu.params import TEST_PARAMS_64

    ck, sk = keys64_fuzz
    rng = random.Random(9000 + seed)
    pattern = _pattern(rng)
    content = _content(rng)
    try:
        parse(pattern)
        want = oracle_match(content, pattern)
    except (ValueError, OracleBudgetExceeded, RecursionError):
        pytest.skip(f"{pattern!r} not executable / too wide")
    ct = trivial_encrypt_str(TEST_PARAMS_64, content)
    for mv in (False, True):
        try:
            res = has_match(sk, ct, pattern, fold="tree",
                            branch_budget=200_000, multivalue=mv)
        except Exception as e:
            pytest.skip(f"{pattern!r}: {type(e).__name__}")
        assert decrypt(ck, res) == want, (pattern, content, mv)
