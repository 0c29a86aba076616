"""Windowed long-content matching (has_match_long).

Must decrypt identically to has_match on the full content: interior
windows give every start `span` headroom (so the engine's bounds pruning
behaves as in the full content) and the final window is flush with the
content end.  Oracle: the plaintext dialect evaluator + direct has_match.
"""

import random

import numpy as np
import pytest

from fhe_regex_tpu import decrypt, has_match, has_match_long, trivial_encrypt_str
from fhe_regex_tpu.params import TEST_PARAMS
from fhe_regex_tpu.regex import parser as P
from fhe_regex_tpu.regex.engine import has_anchor, max_match_span
from fhe_regex_tpu.regex.parser import parse

from fhe_regex_tpu.regex.oracle import OracleBudgetExceeded, oracle_match


SPANS = [
    ("/abc/", 3), ("/a?bc/", 3), ("/ab|cdef/", 4), ("/a{2,5}/", 5),
    ("/[a-d]x/", 2), ("/^abc$/", 3), ("/a*/", None), ("/ab{2,}/", None),
    ("/(ab|c){3}x?/", 7), ("/[^ab]/", 1),
]


@pytest.mark.parametrize("pattern,span", SPANS,
                         ids=[p for p, _ in SPANS])
def test_max_match_span(pattern, span):
    assert max_match_span(parse(pattern)) == span


def test_has_anchor():
    assert has_anchor(parse("/^ab/"), P.SOF)
    assert not has_anchor(parse("/ab/"), P.SOF)
    assert has_anchor(parse("/ab$/"), P.EOF)
    assert has_anchor(parse("/^ab|cd$/"), P.SOF)   # Q2: outer-scoped


LONG_CASES = [
    # (content, pattern) — windows must agree with the direct circuit
    ("xxxxxabcxxxxxxabxxxx", "/abc/"),
    ("xxxxxxxxxxxxxxxxxabc", "/abc/"),      # match flush with the end
    ("abcxxxxxxxxxxxxxxxxx", "/abc/"),
    ("xxxxxxxxxxxxxxxxxxxx", "/abc/"),
    ("xxxxxxxxxabxxxxxxxxx", "/ab?c?/"),
    ("xxxxxxxcdexxxxxxxxxx", "/ab|cde/"),
    ("xxxxxxxxxxxxxxxxaaax", "/a{2,3}x/"),
    ("zaxxxxxxxxxxxxxxxxxx", "/[^ab]a/"),
    ("^abxxxxxxxxxxxxxxxxx", "/\\^ab/"),
    ("abcdefgh", "/^abc/"),                  # SOF: single left window
    ("abcdefgh", "/fgh$/"),                  # EOF: single right window
    ("abcdefgh", "/^abcdefgh$/"),            # both, L == span
    ("abcdefghi", "/^abcd$/"),               # both, L > span -> trivial 0
]


@pytest.mark.parametrize("window", [None, 5, 9])
@pytest.mark.parametrize("content,pattern", LONG_CASES,
                         ids=[f"{c[:6]}~{p}" for c, p in LONG_CASES])
def test_long_matches_direct(content, pattern, window, keys):
    ck, sk = keys
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    want = decrypt(ck, has_match(sk, ct, pattern, backend="jnp"))
    got = decrypt(ck, has_match_long(sk, ct, pattern, window=window,
                                     backend="jnp"))
    assert got == want, (content, pattern, window)


def test_long_unbounded_span_falls_back(keys):
    ck, sk = keys
    ct = trivial_encrypt_str(TEST_PARAMS, "xxxaabcxx")
    got = decrypt(ck, has_match_long(sk, ct, "/a*bc/", backend="jnp"))
    assert got == 1


@pytest.mark.parametrize("seed", range(12))
def test_long_fuzz_vs_oracle(seed, keys):
    """Random bounded-span patterns over longer random contents."""
    from test_native_fuzz import _pattern

    ck, sk = keys
    rng = random.Random(4000 + seed)
    pattern = _pattern(rng)
    content = "".join(rng.choice("abcdexz") for _ in range(rng.randint(8, 14)))
    try:
        re = parse(pattern)
        want = oracle_match(content, pattern)
    except (ValueError, OracleBudgetExceeded, RecursionError):
        pytest.skip(f"{pattern!r} not executable")
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    from fhe_regex_tpu import BranchBudgetExceeded
    try:
        got = decrypt(ck, has_match_long(sk, ct, pattern, window=6,
                                         backend="jnp",
                                         branch_budget=200_000))
    except BranchBudgetExceeded:        # budget parity with the oracle guard
        pytest.skip(f"{pattern!r}: budget")
    assert got == want, (pattern, content)


def test_long_noisy(noisy_keys):
    from fhe_regex_tpu import encrypt_str
    from fhe_regex_tpu.params import TEST_PARAMS_NOISY

    ck, sk = noisy_keys
    ct = encrypt_str(ck, "xxxxxxxxxxxxabcxxxxx")
    assert decrypt(ck, has_match_long(sk, ct, "/abc/", window=6,
                                      backend="jnp")) == 1
    assert decrypt(ck, has_match_long(sk, ct, "/abd/", window=6,
                                      backend="jnp")) == 0


def test_many_long_matches_direct(keys):
    """Batched windowed matching agrees with per-document has_match."""
    from fhe_regex_tpu import has_match_many_long

    ck, sk = keys
    contents = ["xxxxxabcxxxxxxxxxxxx", "xxxxxxxxxxxxxxxxxabc",
                "xxxxxxxxxxxxxxxxxxxx", "abcxxxxxxxxxxxabcxxx"]
    cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c) for c in contents])
    res = has_match_many_long(sk, cts, "/abc/", window=6, backend="jnp")
    assert res.shape[0] == 4
    for c, content in enumerate(contents):
        want = decrypt(ck, has_match(
            sk, trivial_encrypt_str(TEST_PARAMS, content), "/abc/",
            backend="jnp"))
        assert decrypt(ck, res[c]) == want, content


def test_many_long_anchored_fallback(keys):
    from fhe_regex_tpu import has_match_many_long

    ck, sk = keys
    contents = ["abcxxxxx", "xabcxxxx"]
    cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c) for c in contents])
    res = has_match_many_long(sk, cts, "/^abc/", backend="jnp")
    assert [decrypt(ck, r) for r in res] == [1, 0]


def test_long_64bit():
    """Windowed matching + the limb-pair OR reduction at the 64-bit width."""
    from fhe_regex_tpu.crypto.keys import gen_keys
    from fhe_regex_tpu.params import TEST_PARAMS_64

    ck, sk = gen_keys(TEST_PARAMS_64, seed=17)
    ct = trivial_encrypt_str(TEST_PARAMS_64, "xxxxxxxxxxxxabcxxxxx")
    res = has_match_long(sk, ct, "/abc/", window=6)
    assert res.dtype == np.uint64
    assert decrypt(ck, res) == 1
    assert decrypt(ck, has_match_long(sk, ct, "/abd/", window=6)) == 0


def test_long_fixed_launch_shapes(keys, monkeypatch):
    """The OR reduction must only launch the executor's fixed shapes (every
    new shape is one more compiled executable)."""
    import fhe_regex_tpu as F
    from fhe_regex_tpu.regex import executor as X

    ck, sk = keys
    monkeypatch.setattr(X, "default_min_bucket", lambda: 64)
    seen = []
    ex = F._executor_for(sk, "jnp")
    orig = ex._core

    def spying(key, luts, idx, cts):
        seen.append(int(cts.shape[0]))
        return orig(key, luts, idx, cts)

    monkeypatch.setattr(ex, "_core", spying)
    ct = trivial_encrypt_str(TEST_PARAMS, "x" * 40 + "abc" + "x" * 21)
    assert decrypt(ck, F.has_match_long(sk, ct, "/abc/", window=6,
                                        backend="jnp")) == 1
    assert seen and all(s in (64, 256) for s in seen), seen
