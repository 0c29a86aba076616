"""End-to-end engine conformance: the 25 bit-exactness vectors from the
reference (src/regex/engine.rs:256-291) plus the 5 driver configs, run with
trivial content ciphertexts through the REAL batched PBS pipeline —
exactly the reference's test strategy (SURVEY.md §4)."""

import numpy as np
import pytest

from fhe_regex_tpu import decrypt, has_match, trivial_encrypt_str
from fhe_regex_tpu.params import TEST_PARAMS
from fhe_regex_tpu.regex.engine import compile_match


# the 25 reference vectors, verbatim (engine.rs:256-280)
REFERENCE_VECTORS = [
    ("ab", "/ab/", 1),
    ("b", "/ab/", 0),
    ("ab", "/a?b/", 1),
    ("b", "/a?b/", 1),
    ("ab", "/^ab|cd$/", 1),
    (" ab", "/^ab|cd$/", 0),
    (" cd", "/^ab|cd$/", 0),
    ("cd", "/^ab|cd$/", 1),
    ("abcd", "/^ab|cd$/", 0),
    ("abcd", "/ab|cd$/", 1),
    ("abc", "/abc/", 1),
    ("123abc", "/abc/", 1),
    ("123abc456", "/abc/", 1),
    ("123abdc456", "/abc/", 0),
    ("abc456", "/abc/", 1),
    ("bc", "/a*bc/", 1),
    ("cdaabc", "/a*bc/", 1),
    ("cdbc", "/a+bc/", 0),
    ("bc", "/a+bc/", 0),
    ("Ab", "/ab/i", 1),
    ("Ab", "/ab/", 0),
    ("cD", "/ab|cd/i", 1),
    ("cD", "/cD/", 1),
    ("de", "/^ab|cd|de$/", 1),
    (" de", "/^ab|cd|de$/", 0),
]


@pytest.fixture(scope="module")
def server(keys):
    return keys[1]


@pytest.mark.parametrize("content,pattern,exp", REFERENCE_VECTORS,
                         ids=[f"{c}~{p}" for c, p, _ in REFERENCE_VECTORS])
def test_reference_vectors(content, pattern, exp, keys):
    ck, sk = keys
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    res = has_match(sk, ct, pattern)
    assert decrypt(ck, res) == exp


# additional semantics pinned by SURVEY.md §2.4
QUIRK_VECTORS = [
    ("a", "/[a-d]/", 0),      # Q1: lower bound of Between is EXCLUSIVE
    ("b", "/[a-d]/", 1),
    ("d", "/[a-d]/", 1),
    ("e", "/[a-d]/", 0),
    ("A", "/[a-d]/i", 0),     # Q3: /i does not touch Between
    ("x", "/[^abc]/", 1),     # negation
    ("a", "/[^abc]/", 0),
    ("z", "/./", 1),          # Q6: AnyChar is trivially true
    ("", "/a/", 0),           # Q8: empty content -> trivial false
    ("ab", "/a.b/", 0),
    ("axb", "/a.b/", 1),
    ("abbc", "/ab{2}c/", 1),
    ("abc", "/ab{2}c/", 0),
    ("abbbbc", "/ab{2,4}c/", 1),
    ("abbbbbc", "/ab{2,4}c/", 0),
    ("ac", "/ab{,2}c/", 1),
    # trailing-optional pruning: the bounds check (engine.rs:69-71) kills the
    # epsilon variant of a trailing ? at end-of-content, so /^cdxe?$/ does
    # NOT match "cdx" in the reference dialect
    ("cdx", "/^cdxe?$/", 0),
    ("cdxe", "/^cdxe?$/", 1),
    ("cdxx", "/^cdxe?$/", 0),
]


@pytest.mark.parametrize("content,pattern,exp", QUIRK_VECTORS,
                         ids=[f"{c}~{p}" for c, p, _ in QUIRK_VECTORS])
def test_quirk_vectors(content, pattern, exp, keys):
    ck, sk = keys
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    assert decrypt(ck, has_match(sk, ct, pattern)) == exp


@pytest.mark.parametrize("content,pattern,exp",
                         REFERENCE_VECTORS + QUIRK_VECTORS,
                         ids=[f"tree:{c}~{p}" for c, p, _ in
                              REFERENCE_VECTORS + QUIRK_VECTORS])
def test_tree_fold_same_results(content, pattern, exp, keys):
    """fold='tree' (optimizing builder, 3-ary gate trees) decrypts
    identically to the reference fold on every vector."""
    ck, sk = keys
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    assert decrypt(ck, has_match(sk, ct, pattern, fold="tree")) == exp


def test_tree_fold_shallower():
    from fhe_regex_tpu.regex.executor import compile_circuit
    from fhe_regex_tpu.params import TEST_PARAMS as P
    b_ref, r_ref = compile_match(32, "/^ab{2,4}c+d*$/")
    b_tree, r_tree = compile_match(32, "/^ab{2,4}c+d*$/", fold="tree")
    c_ref = compile_circuit(P, b_ref, r_ref)
    c_tree = compile_circuit(P, b_tree, r_tree)
    assert len(c_tree.levels) < len(c_ref.levels) / 3
    assert c_tree.pbs_count <= c_ref.pbs_count


def test_trivial_result_for_anychar(keys):
    """Q10: /./ short-circuits to a trivial (noiseless) ciphertext."""
    ck, sk = keys
    ct = trivial_encrypt_str(TEST_PARAMS, "x")
    res = has_match(sk, ct, "/./")
    assert res[0, :-1].max() == 0  # zero mask == trivial
    assert decrypt(ck, res) == 1


def test_counters_match_reference_semantics():
    """ct_ops / cache_hits replicate the reference's Execution counters
    (execution.rs:56-62) for hand-checked circuits."""
    # 'ab' /ab/: eq+eq+and = 3 ops, no dedup
    b, _ = compile_match(2, "/ab/")
    assert (b.ct_ops, b.cache_hits) == (3, 0)
    # 'ab' /a?b/: 6 ops, 1 hit (eq(1,b) shared between branches 0 and 2)
    b, _ = compile_match(2, "/a?b/")
    assert (b.ct_ops, b.cache_hits) == (6, 1)
    # 'b' /ab/: all branches pruned before any op
    b, _ = compile_match(1, "/ab/")
    assert (b.ct_ops, b.cache_hits) == (0, 0)


def test_nonascii_content_rejected(keys):
    from fhe_regex_tpu import encrypt_str
    ck, _ = keys
    with pytest.raises(ValueError):
        encrypt_str(ck, "héllo")


def test_has_match_many(keys):
    """Batched-contents serving path agrees with per-content matches."""
    from fhe_regex_tpu import has_match_many
    import numpy as np
    ck, sk = keys
    contents = ["abc", "abd", "xbc", "aabc", "abca"][:4]
    contents = [c.ljust(4, "z") for c in contents]
    cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c) for c in contents])
    res = has_match_many(sk, cts, "/abc/")
    got = [decrypt(ck, res[i]) for i in range(len(contents))]
    want = [decrypt(ck, has_match(sk, trivial_encrypt_str(TEST_PARAMS, c), "/abc/"))
            for c in contents]
    assert got == want == [1, 0, 0, 1]


def test_real_encryption_roundtrip(noisy_keys):
    """Full client-side encryption (not trivial) through the engine."""
    from fhe_regex_tpu import encrypt_str
    from fhe_regex_tpu.params import TEST_PARAMS_NOISY
    ck, sk = noisy_keys
    ct = encrypt_str(ck, "xaby")
    assert decrypt(ck, has_match(sk, ct, "/ab/")) == 1
    assert decrypt(ck, has_match(sk, ct, "/ba/")) == 0


def test_executor_profile_stats(keys):
    """run(profile=True) records per-level width/active/seconds (the device-side
    analog of the reference's ct-op logging, SURVEY.md §5)."""
    from fhe_regex_tpu.ops.pbs import prepare_server_key
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import Executor, compile_circuit

    ck, sk = keys
    builder, root = compile_match(3, "/ab?c/", fold="tree")
    circuit = compile_circuit(TEST_PARAMS, builder, root)
    ex = Executor(TEST_PARAMS, prepare_server_key(TEST_PARAMS, sk, "jnp"))
    res = ex.run(circuit, trivial_encrypt_str(TEST_PARAMS, "abc"),
                 profile=True)
    assert decrypt(ck, res) == 1
    stats = ex.last_run_stats
    assert len(stats) == len(circuit.levels)
    assert all(s["seconds"] > 0 and s["active"] >= 1 for s in stats)
    assert sum(s["active"] for s in stats) == circuit.pbs_count
