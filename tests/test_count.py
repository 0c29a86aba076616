"""Encrypted match counting (count_matches / circuit.count_bits)."""

import random

import numpy as np
import pytest

from fhe_regex_tpu import (count_matches, decrypt_count, has_match_positions,
                           decrypt, trivial_encrypt_str)
from fhe_regex_tpu.params import TEST_PARAMS
from fhe_regex_tpu.regex.parser import parse

from test_multipattern import _oracle_positions


CASES = [
    ("abcabcabc", "/abc/", 3), ("xxxxxx", "/abc/", 0),
    ("aaaa", "/aa/", 3), ("abab", "/a/", 2),
    ("aaaaaaaaaaaa", "/a/", 12),            # carries past one digit
    ("abcabc", "/./", 6),                   # trivially-true bits (constants)
    ("xaxbxc", "/x[a-d]/", 2),              # Q1: b,c match, a doesn't... (a>a false)
]


@pytest.mark.parametrize("content,pattern,want", CASES,
                         ids=[f"{c[:6]}~{p}" for c, p, _ in CASES])
def test_count_matches(content, pattern, want, keys):
    ck, sk = keys
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    # pin the expectation against the per-position oracle too
    assert sum(_oracle_positions(content, pattern)) == want
    res = count_matches(sk, ct, pattern, backend="jnp")
    assert decrypt_count(ck, res) == want, (content, pattern)


@pytest.mark.parametrize("seed", range(8))
def test_count_fuzz(seed, keys):
    from test_native_fuzz import _pattern

    ck, sk = keys
    rng = random.Random(6000 + seed)
    pattern = _pattern(rng)
    content = "".join(rng.choice("abcde") for _ in range(rng.randint(1, 8)))
    from fhe_regex_tpu.regex.oracle import OracleBudgetExceeded
    try:
        parse(pattern)
        want = sum(_oracle_positions(content, pattern))
    except (ValueError, RecursionError, OracleBudgetExceeded):
        pytest.skip(f"{pattern!r} not executable")
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    from fhe_regex_tpu import BranchBudgetExceeded
    try:
        res = count_matches(sk, ct, pattern, backend="jnp",
                            branch_budget=200_000)
    except BranchBudgetExceeded:
        pytest.skip("budget")
    assert decrypt_count(ck, res) == want, (pattern, content)


def test_count_noisy(noisy_keys):
    from fhe_regex_tpu import encrypt_str
    from fhe_regex_tpu.params import TEST_PARAMS_NOISY

    ck, sk = noisy_keys
    ct = encrypt_str(ck, "abcabc")
    res = count_matches(sk, ct, "/abc/")
    assert decrypt_count(ck, res) == 2


def test_count_multivalue_rejected(keys):
    """Counting LUT factors are dense — the mv compile must refuse with a
    clear error instead of silently degrading the noise margin."""
    from fhe_regex_tpu.params import TPU_MESSAGE_2_CARRY_2
    from fhe_regex_tpu.regex.circuit import CircuitBuilder, Node, count_bits
    from fhe_regex_tpu.regex.executor import compile_circuit

    b = CircuitBuilder(2)
    bits = [b.ct_eq(0, ord("a")), b.ct_eq(1, ord("b"))]
    digits = count_bits(b, bits)
    roots = [Node(("count", i), d) for i, d in enumerate(digits)]
    with pytest.raises(ValueError, match="multivalue"):
        compile_circuit(TPU_MESSAGE_2_CARRY_2, b, roots, multivalue=True)
