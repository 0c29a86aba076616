"""Public gate-level circuit API: CircuitBuilder + run_circuit.

The reference exposes its execution context's gate methods as public API
(Execution::{ct_eq, ct_ge, ct_le, ct_and, ct_or, ct_not, ct_true, ct_false,
ct_constant}, execution.rs:46-222) so library users can build custom
homomorphic predicates; CircuitBuilder is our symbolic twin of that surface
and run_circuit/executor_for execute it through the real batched PBS
pipeline.
"""

import numpy as np
import pytest

from fhe_regex_tpu import (
    CircuitBuilder,
    compile_circuit,
    decrypt,
    executor_for,
    run_circuit,
    trivial_encrypt_str,
)
from fhe_regex_tpu.params import TEST_PARAMS


def _predicate(b: CircuitBuilder):
    """(content[0] in {'a','b'}) AND NOT (content[1] == 'z')"""
    first = b.ct_or(b.ct_eq(0, ord("a")), b.ct_eq(0, ord("b")))
    return b.ct_and(first, b.ct_not(b.ct_eq(1, ord("z"))))


def _plain(s: str) -> int:
    return int(s[0] in "ab" and s[1] != "z")


@pytest.mark.parametrize("mode", ["strict", "opt"])
@pytest.mark.parametrize("content", ["ab", "az", "bz", "xy", "by"])
def test_custom_predicate(mode, content, keys):
    ck, sk = keys
    b = CircuitBuilder(2, mode=mode)
    root = _predicate(b)
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    res = run_circuit(sk, b, root, ct, backend="jnp")
    assert decrypt(ck, res) == _plain(content), content


def test_custom_multi_root(keys):
    """A list of roots returns one encrypted bit per root."""
    ck, sk = keys
    b = CircuitBuilder(2)
    roots = [b.ct_eq(0, ord("a")),
             b.ct_ge(1, ord("a")),       # strict > 'a' (Q1 contract)
             b.ct_true()]
    ct = trivial_encrypt_str(TEST_PARAMS, "ab")
    res = run_circuit(sk, b, roots, ct, backend="jnp")
    assert res.shape[0] == 3
    assert [decrypt(ck, r) for r in res] == [1, 1, 1]


def test_counters_match_reference_semantics():
    """ct_ops / cache_hits follow execution.rs semantics: constants and
    short-circuits bypass both (Q10), repeats hit the cache (Q11)."""
    b = CircuitBuilder(2)
    e1 = b.ct_eq(0, ord("a"))
    e2 = b.ct_eq(0, ord("a"))          # cache hit
    b.ct_and(e1, e2)                   # counted op
    b.ct_and(b.ct_true(), e1)          # short-circuit: no op, no cache entry
    assert b.ct_ops == 2               # eq + and
    assert b.cache_hits == 1


@pytest.mark.parametrize("content", ["ab", "az", "xy"])
def test_fused_levels_matches_per_level(content, keys):
    """The megarun (whole level loop in ONE jitted dispatch) must produce
    the same ciphertext slab result as the per-level launch path."""
    ck, sk = keys
    b = CircuitBuilder(2)
    root = _predicate(b)
    circuit = compile_circuit(TEST_PARAMS, b, root)
    ex = executor_for(sk)
    ct = trivial_encrypt_str(TEST_PARAMS, content)
    out_fused = ex.run(circuit, ct, fuse=True)
    out_steps = ex.run(circuit, ct, fuse=False)
    assert np.array_equal(out_fused, out_steps)
    assert decrypt(ck, out_fused) == _plain(content)


def test_fused_levels_matches_per_level_mv(keys):
    """Fused dispatch on a MULTI-VALUE compiled circuit."""
    ck, sk = keys
    b = CircuitBuilder(2)
    root = _predicate(b)
    circuit = compile_circuit(TEST_PARAMS, b, root, multivalue=True)
    ex = executor_for(sk)
    for content in ("ab", "xy"):
        ct = trivial_encrypt_str(TEST_PARAMS, content)
        out_fused = ex.run(circuit, ct, fuse=True)
        out_steps = ex.run(circuit, ct, fuse=False)
        assert np.array_equal(out_fused, out_steps)
        assert decrypt(ck, out_fused) == _plain(content)


def test_executor_for_reuses_compiled_circuit(keys):
    ck, sk = keys
    b = CircuitBuilder(1)
    root = b.force_node(b.ct_eq(0, ord("q")))
    circuit = compile_circuit(TEST_PARAMS, b, root)
    ex = executor_for(sk, backend="jnp")
    for content, want in [("q", 1), ("r", 0)]:
        res = ex.run(circuit, trivial_encrypt_str(TEST_PARAMS, content))
        assert decrypt(ck, res) == want


def test_default_fuse_size_cap(monkeypatch):
    """Megarun default: FUSE_LEVELS below FUSE_MAX_PBS, off above, env forces.

    The cap exists because the fused program grows with the circuit, and
    with it the cold XLA compile."""
    from fhe_regex_tpu.regex import executor as ex_mod

    class FakeCircuit:
        def __init__(self, pbs_count):
            self.pbs_count = pbs_count
            # classic circuits: rotations == bootstraps (the advisor-r3 fix
            # caps fusing on rotation_count, which is smaller under mv)
            self.rotation_count = pbs_count

    small = FakeCircuit(ex_mod.FUSE_MAX_PBS)
    big = FakeCircuit(ex_mod.FUSE_MAX_PBS + 1)

    monkeypatch.delenv("FHE_REGEX_FUSE_LEVELS", raising=False)
    monkeypatch.setattr(ex_mod, "FUSE_LEVELS", True)
    assert ex_mod.default_fuse(small) is True
    assert ex_mod.default_fuse(big) is False

    monkeypatch.setattr(ex_mod, "FUSE_LEVELS", False)
    assert ex_mod.default_fuse(small) is False

    monkeypatch.setenv("FHE_REGEX_FUSE_LEVELS", "1")
    assert ex_mod.default_fuse(big) is True
    monkeypatch.setenv("FHE_REGEX_FUSE_LEVELS", "0")
    assert ex_mod.default_fuse(small) is False
