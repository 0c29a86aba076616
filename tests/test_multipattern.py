"""Multi-pattern circuits: many patterns compiled onto ONE shared
hash-consed op DAG (compile_match_multi / has_match_patterns /
has_match_many_patterns).

The reference's memo cache only ever spans one has_match call
(execution.rs:37-43); the multi-pattern compile generalizes the same
structural dedup across patterns.  Correctness oracle: the per-pattern
single-root pipeline (itself pinned to the 25 reference vectors).
"""

import numpy as np
import pytest

from fhe_regex_tpu import (
    decrypt,
    has_match,
    has_match_many,
    has_match_many_patterns,
    has_match_patterns,
    trivial_encrypt_str,
)
from fhe_regex_tpu.params import TEST_PARAMS
from fhe_regex_tpu.regex import native
from fhe_regex_tpu.regex.engine import (
    BranchBudgetExceeded,
    compile_match,
    compile_match_multi,
)

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native lib not built")

PATTERNS = ["/ab/", "/a?b/", "/^ab|cd$/", "/[a-d]c/", "/ab|cd/i"]
CONTENTS = ["ab", "cd", "bc", "abcd", "Bc"]


@pytest.mark.parametrize("fold", ["reference", "tree"])
@pytest.mark.parametrize("engine", ["python", "native"])
def test_has_match_patterns_agrees_with_single(fold, engine, keys):
    if engine == "native" and not native.available():
        pytest.skip("native lib not built")
    ck, sk = keys
    for content in CONTENTS:
        ct = trivial_encrypt_str(TEST_PARAMS, content)
        res = has_match_patterns(sk, ct, PATTERNS, backend="jnp",
                                 fold=fold, engine=engine)
        assert res.shape[0] == len(PATTERNS)
        for pi, pattern in enumerate(PATTERNS):
            one = has_match(sk, ct, pattern, backend="jnp", fold=fold,
                            engine=engine)
            assert decrypt(ck, res[pi]) == decrypt(ck, one), (content, pattern)


@pytest.mark.parametrize("fold", ["reference", "tree"])
def test_cross_pattern_sharing(fold):
    """Shared subexpressions are built once: the joint circuit is strictly
    smaller than the sum of the individual ones."""
    pats = ["/abc/", "/abd/", "/ab/"]
    n = 6
    joint, roots = compile_match_multi(n, pats, fold=fold)
    assert len(roots) == len(pats)
    total = sum(len(compile_match(n, p, fold=fold)[0].ops) for p in pats)
    assert len(joint.ops) < total


@pytest.mark.parametrize("fold", ["reference", "tree"])
@needs_native
def test_native_multi_matches_python(fold):
    pats = ["/abc/", "/a?b/", "/^a[b-d]{2,4}e$/i", "/x|y|z/"]
    n = 5
    pb, proots = compile_match_multi(n, pats, fold=fold)
    nb, nroots = native.compile_match_native_multi(n, pats, fold=fold)
    assert (nb.ct_ops, nb.cache_hits) == (pb.ct_ops, pb.cache_hits)
    assert nb.num_content_slots == pb.num_content_slots
    assert [r.val for r in nroots] == [r.val for r in proots]
    assert nb.ops == pb.ops


def test_has_match_many_patterns(keys):
    ck, sk = keys
    contents = ["ab", "cd", "xy"]
    pats = ["/ab/", "/cd/", "/ab|cd/"]
    cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c) for c in contents])
    res = has_match_many_patterns(sk, cts, pats, backend="jnp")
    assert res.shape[:2] == (len(contents), len(pats))
    for pi, pattern in enumerate(pats):
        ref = has_match_many(sk, cts, pattern, backend="jnp")
        for ci in range(len(contents)):
            assert decrypt(ck, res[ci, pi]) == decrypt(ck, ref[ci]), (
                contents[ci], pattern)


def test_single_root_list_keeps_rank(keys):
    """compile_circuit with a 1-element root list returns [1, blocks, n+1]."""
    from fhe_regex_tpu.ops.pbs import prepare_server_key
    from fhe_regex_tpu.regex.executor import Executor, compile_circuit

    ck, sk = keys
    builder, roots = compile_match_multi(2, ["/ab/"], fold="tree")
    circuit = compile_circuit(TEST_PARAMS, builder, roots)
    ex = Executor(TEST_PARAMS, prepare_server_key(TEST_PARAMS, sk, "jnp"))
    res = ex.run(circuit, trivial_encrypt_str(TEST_PARAMS, "ab"))
    assert res.shape[0] == 1
    assert decrypt(ck, res[0]) == 1


def test_constant_roots_mix(keys):
    """Patterns whose circuits are compile-time constants (Q6/Q8 pruning)
    interleave correctly with real roots."""
    ck, sk = keys
    ct = trivial_encrypt_str(TEST_PARAMS, "ab")
    pats = ["/./", "/ab/", "/zz/"]   # trivial TRUE, real, real
    res = has_match_patterns(sk, ct, pats, backend="jnp")
    assert [decrypt(ck, r) for r in res] == [1, 1, 0]


@pytest.mark.parametrize("engine", ["python", "native"])
def test_multi_budget_is_per_pattern(engine):
    if engine == "native" and not native.available():
        pytest.skip("native lib not built")
    from fhe_regex_tpu import _compile_multi

    # /a*bc/ at len 6 exceeds a tiny budget; /ab/ alone does not
    with pytest.raises(BranchBudgetExceeded):
        _compile_multi(TEST_PARAMS, 6, ["/ab/", "/a*bc/"], "tree", engine, 3)
    builder, roots = _compile_multi(TEST_PARAMS, 6, ["/ab/", "/ab/"],
                                    "tree", engine, 50)
    assert len(roots) == 2


# ---------------- per-position match bits ----------------

def _oracle_positions(content: str, pattern: str):
    """Plaintext per-start-position truth, via the fuzz oracle's evaluator."""
    from fhe_regex_tpu.regex.oracle import _oracle_branches
    from fhe_regex_tpu.regex.parser import parse as _parse
    ast = _parse(pattern)
    data = content.encode("ascii")
    return [int(any(v for v, _ in _oracle_branches(data, ast, i, [0])))
            for i in range(len(data))]


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("content,pattern", [
    ("abcabc", "/abc/"), ("xxabyy", "/ab?c?/"), ("abc", "/^abc$/"),
    ("aaaa", "/a+b/"), ("bcbcbc", "/[a-d]c/"),
])
def test_match_positions_oracle(engine, content, pattern, keys):
    from fhe_regex_tpu import has_match_positions

    if engine == "native" and not native.available():
        pytest.skip("native lib not built")
    ck, sk = keys
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    res = has_match_positions(sk, ct, pattern, backend="jnp", engine=engine)
    got = [decrypt(ck, res[i]) for i in range(len(content))]
    assert got == _oracle_positions(content, pattern), (content, pattern)
    # the global has_match bit is the OR of the position bits
    one = decrypt(ck, has_match(sk, ct, pattern, backend="jnp"))
    assert one == int(any(got))


@pytest.mark.parametrize("fold", ["reference", "tree"])
@needs_native
def test_native_positions_matches_python(fold):
    from fhe_regex_tpu.regex.engine import compile_match_positions
    from fhe_regex_tpu.regex.native import compile_match_native_positions

    n, pattern = 5, "/a[b-d]?c/"
    pb, proots = compile_match_positions(n, pattern, fold=fold)
    nb, nroots = compile_match_native_positions(n, pattern, fold=fold)
    assert (nb.ct_ops, nb.cache_hits) == (pb.ct_ops, pb.cache_hits)
    assert [r.val for r in nroots] == [r.val for r in proots]
    assert nb.ops == pb.ops


@pytest.mark.parametrize("mv", [False, True])
def test_has_match_many_positions(mv, keys):
    from fhe_regex_tpu import has_match_many_positions

    ck, sk = keys
    contents = ["abcabc", "xabcxx", "xxxxxx"]
    cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c) for c in contents])
    res = has_match_many_positions(sk, cts, "/abc/", backend="jnp",
                                   multivalue=mv)
    assert res.shape[:2] == (3, 6)
    got = [[decrypt(ck, res[c, i]) for i in range(6)] for c in range(3)]
    assert got == [_oracle_positions(c, "/abc/") for c in contents]
