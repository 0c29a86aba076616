"""Multi-value bootstrapping: one blind rotation, many LUT outputs.

Spec layer first: every production test polynomial factors EXACTLY as
u (*) v over the negacyclic ring (u sparse on the static window-boundary
support, v the common half-delta all-ones poly), so rotating v once serves
every LUT on the same input; outputs are derived at sample-extract time.
Noise: only the blind-rotation component is amplified (by ||u||_2), which
keeps >= MIN_SIGMA_MARGIN at our parameters (asserted here).
"""

import numpy as np
import pytest

from fhe_regex_tpu.crypto import golden, lwe
from fhe_regex_tpu.crypto.glwe import negacyclic_polymul
from fhe_regex_tpu.ops.luts import (
    LUT_AND2, LUT_AND3, LUT_EQ, LUT_GT, LUT_GT_COMBINE, LUT_LE, LUT_LT,
    LUT_OR2, LUT_OR3, lut_fn, mv_norm2, mv_support_positions, mv_weights,
)
from fhe_regex_tpu.params import (
    TEST_PARAMS, TEST_PARAMS_NOISY, TPU_MESSAGE_2_CARRY_2,
)

PRODUCTION_KEYS = (
    [LUT_EQ(c) for c in range(16)] + [LUT_GT(c) for c in range(16)]
    + [LUT_LT(c) for c in range(16)] + [LUT_LE(c) for c in range(16)]
    + [LUT_AND2, LUT_OR2, LUT_AND3, LUT_OR3, LUT_GT_COMBINE]
)


@pytest.mark.parametrize("params", [TEST_PARAMS, TPU_MESSAGE_2_CARRY_2],
                         ids=lambda p: p.name)
def test_factorization_exact(params):
    """u (*) v == make_lut_poly(f) exactly (mod 2^torus_bits) for every
    production LUT."""
    N = params.polynomial_size
    v = golden.mv_testpoly(params)
    pos = mv_support_positions(params)
    for key in PRODUCTION_KEYS:
        t = golden.make_lut_poly(params, lut_fn(key))
        w = mv_weights(params, key)
        u = np.zeros(N, dtype=v.dtype)
        u[pos] = w.astype(np.int64) & ((1 << params.torus_bits) - 1)
        prod = negacyclic_polymul(u, v, params.torus_bits)
        assert np.array_equal(prod.astype(t.dtype), t), key


def test_support_is_static_and_sparse():
    pos = mv_support_positions(TPU_MESSAGE_2_CARRY_2)
    assert len(pos) == 16
    assert pos[0] > 0 and pos[-1] < TPU_MESSAGE_2_CARRY_2.polynomial_size
    # boolean LUT factors are tiny (worst: or_and3's alternating pattern)
    assert max(mv_norm2(TPU_MESSAGE_2_CARRY_2, k) for k in PRODUCTION_KEYS) <= 12


def test_noise_margin_multivalue():
    """Worst-case LUT margin with the max production ||u||_2^2 stays >= 5
    sigma at BOTH production torus widths (modswitch + keyswitch dominate;
    blind rotation is the only amplified term)."""
    from fhe_regex_tpu.params import TPU64_MESSAGE_2_CARRY_2

    for p in (TPU_MESSAGE_2_CARRY_2, TPU64_MESSAGE_2_CARRY_2):
        u2 = max(mv_norm2(p, k) for k in PRODUCTION_KEYS)
        assert p.noise_budget_report(mv_norm2=u2)["sigma_margin"] >= 5.0, p.name


def test_golden_mv_pbs_matches_classic(keys):
    """ONE rotation of v + derived extracts decrypt exactly like per-LUT
    classic bootstraps (zero-noise keys -> bit-exact)."""
    ck, sk = keys
    p = TEST_PARAMS
    group = [LUT_EQ(5), LUT_GT(5), LUT_LE(9)]
    for m in [0, 3, 5, 9, 15]:
        ct = lwe.encrypt_lwe(p, ck.lwe_key, m, ck.rng)
        outs = golden.mv_pbs(p, sk.bsk, sk.ksk, ct,
                             [mv_weights(p, k) for k in group])
        for key, out in zip(group, outs):
            want = golden.pbs(p, sk.bsk, sk.ksk, ct,
                              golden.make_lut_poly(p, lut_fn(key)))
            assert (lwe.decrypt_lwe(p, ck.lwe_key, out)
                    == lwe.decrypt_lwe(p, ck.lwe_key, want)
                    == lut_fn(key)(m)), (key, m)


def test_golden_mv_pbs_noisy(noisy_keys):
    """Derived outputs decrypt correctly through real noise."""
    ck, sk = noisy_keys
    p = TEST_PARAMS_NOISY
    group = [LUT_EQ(2), LUT_GT(2)]
    for m in [1, 2, 3]:
        ct = lwe.encrypt_lwe(p, ck.lwe_key, m, ck.rng)
        outs = golden.mv_pbs(p, sk.bsk, sk.ksk, ct,
                             [mv_weights(p, k) for k in group])
        assert lwe.decrypt_lwe(p, ck.lwe_key, outs[0]) == int(m == 2)
        assert lwe.decrypt_lwe(p, ck.lwe_key, outs[1]) == int(m > 2)


def test_mv_pbs_batch_jnp(keys):
    """jnp runtime: grouped batched multi-value PBS == classic per-LUT PBS
    (zero-noise keys -> identical plaintexts)."""
    import jax.numpy as jnp

    from fhe_regex_tpu.ops.mv import mv_pbs_batch
    from fhe_regex_tpu.ops.pbs import pbs_batch, server_key_device_arrays

    ck, sk = keys
    p = TEST_PARAMS
    bsk, ksk = server_key_device_arrays(sk)
    group = [LUT_EQ(5), LUT_GT(5), LUT_AND2, LUT_OR2]
    # two unique inputs, four outputs (2 LUTs each)
    ms = [5, 3]
    rot = np.stack([lwe.encrypt_lwe(p, ck.lwe_key, m, ck.rng) for m in ms])
    weights = np.stack([mv_weights(p, k) for k in group]).astype(np.int32)
    leader = np.asarray([0, 0, 1, 1], np.int32)
    out = np.asarray(mv_pbs_batch(p, bsk, ksk, jnp.asarray(weights),
                                  jnp.asarray(leader),
                                  jnp.asarray(rot.view(np.int32))))
    got = [lwe.decrypt_lwe(p, ck.lwe_key, out[i].view(np.uint32))
           for i in range(4)]
    assert got == [1, 0, 1, 1]  # eq5(5), gt5(5), and2(3), or2(3)

    # classic path agreement on the same inputs
    luts = np.stack([golden.make_lut_poly(p, lut_fn(k)) for k in group])
    cts = rot[leader]
    ref = np.asarray(pbs_batch(p, bsk, ksk, jnp.asarray(luts.view(np.int32)),
                               jnp.arange(4, dtype=np.int32),
                               jnp.asarray(cts.view(np.int32))))
    ref_pt = [lwe.decrypt_lwe(p, ck.lwe_key, ref[i].view(np.uint32))
              for i in range(4)]
    assert got == ref_pt


# ---------------- end-to-end through the executor ----------------

VECTORS = [
    ("abc", "/b/", 1), ("abc", "/x/", 0),
    ("b", "/[a-d]/", 1), ("e", "/[a-d]/", 0),       # Between: shared hi input
    ("bc", "/[abc][bc]/", 1), ("xc", "/[abc][bc]/", 0),  # Range: shared eq
    ("abcd", "/^ab|cd$/", 0), ("cd", "/^ab|cd$/", 1),
    ("cdaabc", "/a*bc/", 1), ("", "/a/", 0),
    ("abbbbc", "/ab{2,4}c/", 1),
]


@pytest.mark.parametrize("fold", ["reference", "tree"])
def test_has_match_multivalue(fold, keys):
    """Full pipeline with shared-rotation levels: identical decrypted bits
    (zero-noise keys -> exactness by construction), fewer rotations."""
    from fhe_regex_tpu import decrypt, has_match, trivial_encrypt_str

    ck, sk = keys
    for content, pattern, want in VECTORS:
        ct = trivial_encrypt_str(TEST_PARAMS, content)
        res = has_match(sk, ct, pattern, backend="jnp", fold=fold,
                        multivalue=True)
        assert decrypt(ck, res) == want, (content, pattern, fold)


def test_multivalue_saves_rotations():
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import compile_circuit

    builder, root = compile_match(2, "/^[a-d][^xyz]$/i", fold="tree")
    circuit = compile_circuit(TEST_PARAMS, builder, root, multivalue=True)
    assert circuit.multivalue
    assert circuit.rotation_count < circuit.pbs_count


def test_has_match_multivalue_noisy(noisy_keys):
    """Real encryption + real noise through the shared-rotation executor."""
    from fhe_regex_tpu import decrypt, encrypt_str, has_match

    ck, sk = noisy_keys
    ct = encrypt_str(ck, "bd")
    for pattern, want in [("/^[a-d][^xyz]$/", 1), ("/^[a-d]x$/", 0),
                          ("/bd/", 1)]:
        res = has_match(sk, ct, pattern, backend="jnp", multivalue=True)
        assert decrypt(ck, res) == want, pattern


def test_multivalue_positions_and_patterns(keys):
    from fhe_regex_tpu import (decrypt, has_match_patterns,
                               has_match_positions, trivial_encrypt_str)

    ck, sk = keys
    ct = trivial_encrypt_str(TEST_PARAMS, "abcabc")
    res = has_match_positions(sk, ct, "/abc/", backend="jnp", multivalue=True)
    assert [decrypt(ck, r) for r in res] == [1, 0, 0, 1, 0, 0]
    res = has_match_patterns(sk, ct, ["/abc/", "/abd/", "/zz/"],
                             backend="jnp", multivalue=True)
    assert [decrypt(ck, r) for r in res] == [1, 0, 0]


def test_factorization_exact_64bit():
    """The factorization holds at the 64-bit torus width too."""
    from fhe_regex_tpu.params import TEST_PARAMS_64 as P64

    N = P64.polynomial_size
    v = golden.mv_testpoly(P64)
    pos = mv_support_positions(P64)
    for key in [LUT_EQ(3), LUT_GT(7), LUT_OR2, LUT_GT_COMBINE]:
        t = golden.make_lut_poly(P64, lut_fn(key))
        w = mv_weights(P64, key)
        u = np.zeros(N, dtype=np.uint64)
        u[pos] = np.asarray(w, np.int64).astype(np.uint64)
        prod = negacyclic_polymul(u, v, 64)
        assert np.array_equal(prod.astype(t.dtype), t), key


@pytest.fixture(scope="module")
def keys64():
    from fhe_regex_tpu.crypto.keys import gen_keys
    from fhe_regex_tpu.params import TEST_PARAMS_64 as P64
    return gen_keys(P64, seed=11)


def test_has_match_multivalue_64bit(keys64):
    """Full 64-bit pipeline with shared rotations (int32 limb pairs):
    identical decrypted bits to the classic jnp64 path."""
    from fhe_regex_tpu import decrypt, has_match, trivial_encrypt_str
    from fhe_regex_tpu.params import TEST_PARAMS_64 as P64

    ck, sk = keys64
    for content, pattern, want in [("abc", "/b/", 1), ("abc", "/x/", 0),
                                   ("b", "/[a-d]/", 1), ("e", "/[a-d]/", 0),
                                   ("cd", "/^ab|cd$/", 1)]:
        ct = trivial_encrypt_str(P64, content)
        res = has_match(sk, ct, pattern, multivalue=True)
        assert res.dtype == np.uint64
        assert decrypt(ck, res) == want, (content, pattern)


def test_run_many_multivalue_64bit(keys64):
    from fhe_regex_tpu import decrypt, has_match_many, trivial_encrypt_str
    from fhe_regex_tpu.params import TEST_PARAMS_64 as P64

    ck, sk = keys64
    contents = ["bq", "xq", "dd"]
    cts = np.stack([trivial_encrypt_str(P64, c) for c in contents])
    res = has_match_many(sk, cts, "/^[a-d][^xyz]$/i", multivalue=True)
    assert [decrypt(ck, res[i]) for i in range(3)] == [1, 0, 1]


@pytest.mark.parametrize("wide", [False, True])
def test_run_many_multivalue(wide, keys):
    """Packed serving path with shared rotations: identical results to the
    classic run_many (zero-noise keys)."""
    import numpy as np

    from fhe_regex_tpu import decrypt, trivial_encrypt_str
    from fhe_regex_tpu.ops.pbs import prepare_server_key
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import Executor, compile_circuit

    ck, sk = keys
    contents = ["bq", "xq", "dd", "aq", "cz"]
    cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c) for c in contents])
    builder, root = compile_match(2, "/^[a-d][^xyz]$/i", fold="tree")
    ex = Executor(TEST_PARAMS, prepare_server_key(TEST_PARAMS, sk, "jnp"))
    classic = compile_circuit(TEST_PARAMS, builder, root)
    mv = compile_circuit(TEST_PARAMS, builder, root, multivalue=True)
    want = [decrypt(ck, r) for r in ex.run_many(classic, cts,
                                                wide_batch=wide)]
    got = [decrypt(ck, r) for r in ex.run_many(mv, cts, wide_batch=wide)]
    # Q1: [a-d] is strict > 'a', so 'b'/'d'/'c' match, 'a' doesn't;
    # [^xyz] rejects 'z'
    assert got == want == [1, 0, 1, 0, 0]


def test_run_many_multivalue_multiroot(keys):
    import numpy as np

    from fhe_regex_tpu import decrypt, has_match_many_patterns, trivial_encrypt_str

    ck, sk = keys
    contents = ["abx", "cdx", "xxx"]
    pats = ["/ab/", "/cd/", "/[a-d]d/"]
    cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c) for c in contents])
    ref = has_match_many_patterns(sk, cts, pats, backend="jnp")
    got = has_match_many_patterns(sk, cts, pats, backend="jnp",
                                  multivalue=True)
    assert [[decrypt(ck, got[c, p]) for p in range(3)] for c in range(3)] \
        == [[decrypt(ck, ref[c, p]) for p in range(3)] for c in range(3)]


def test_mv_auto_default_resolution(monkeypatch):
    """Packed paths default to auto (None); env and explicit args override."""
    from fhe_regex_tpu import _resolve_multivalue

    monkeypatch.delenv("FHE_REGEX_MULTIVALUE", raising=False)
    assert _resolve_multivalue(None, TEST_PARAMS, None, packed=True) is None
    assert _resolve_multivalue(None, TEST_PARAMS, None, packed=False) is False
    assert _resolve_multivalue(True, TEST_PARAMS, None, packed=False) is True
    assert _resolve_multivalue(False, TEST_PARAMS, None, packed=True) is False
    monkeypatch.setenv("FHE_REGEX_MULTIVALUE", "1")
    assert _resolve_multivalue(None, TEST_PARAMS, None, packed=False) is True
    monkeypatch.setenv("FHE_REGEX_MULTIVALUE", "0")
    assert _resolve_multivalue(None, TEST_PARAMS, None, packed=True) is False


def test_mv_auto_default_compile(monkeypatch):
    """auto keeps the shared-rotation plan iff the savings clear the
    threshold (and never when a margin check fails)."""
    from fhe_regex_tpu import MV_AUTO_MIN_SAVINGS, _compile_auto_mv
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import compile_circuit

    monkeypatch.delenv("FHE_REGEX_MV_MIN_SAVINGS", raising=False)
    for pattern, L in [("/^[a-d][^xyz]$/i", 2), ("/^abc$/", 3),
                       ("/abc/", 8), ("/^(ab|cd)[a-z]{3,}e?$/i", 16)]:
        builder, root = compile_match(L, pattern, fold="tree")
        mv_c = compile_circuit(TEST_PARAMS, builder, root, multivalue=True)
        savings = 1.0 - mv_c.rotation_count / mv_c.pbs_count
        decided = _compile_auto_mv(TEST_PARAMS, builder, root, None)
        assert decided.multivalue == (savings >= MV_AUTO_MIN_SAVINGS), \
            (pattern, savings)
        # explicit always wins over auto
        assert _compile_auto_mv(TEST_PARAMS, builder, root, False).multivalue \
            is False
        assert _compile_auto_mv(TEST_PARAMS, builder, root, True).multivalue \
            is True
    # the class pattern must actually exercise the mv branch of auto
    builder, root = compile_match(2, "/^[a-d][^xyz]$/i", fold="tree")
    assert _compile_auto_mv(TEST_PARAMS, builder, root, None).multivalue


def test_mv_auto_default_run_many(keys, monkeypatch):
    """has_match_many with no multivalue arg (the new serving default)
    decrypts identically to the forced-classic run."""
    from fhe_regex_tpu import decrypt, has_match_many, trivial_encrypt_str

    monkeypatch.delenv("FHE_REGEX_MULTIVALUE", raising=False)
    ck, sk = keys
    contents = ["bq", "xq", "dd", "aq"]
    cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c) for c in contents])
    auto = has_match_many(sk, cts, "/^[a-d][^xyz]$/i", backend="jnp")
    classic = has_match_many(sk, cts, "/^[a-d][^xyz]$/i", backend="jnp",
                             multivalue=False)
    assert [decrypt(ck, auto[i]) for i in range(4)] \
        == [decrypt(ck, classic[i]) for i in range(4)] == [1, 0, 1, 0]


def test_mv_output_noise_matches_model(noisy_keys):
    """Empirical phase-error std of multi-value outputs stays within the
    analytic model: var_out ~= ||u||^2 * var_br + var_ks (the blind-rotation
    term is the only amplified one)."""
    import math

    import jax.numpy as jnp

    from fhe_regex_tpu.ops.mv import mv_pbs_batch
    from fhe_regex_tpu.ops.pbs import server_key_device_arrays

    ck, sk = noisy_keys
    p = TEST_PARAMS_NOISY
    key = LUT_GT_COMBINE                      # worst production factor
    u2 = mv_norm2(p, key)
    B = 48
    rot = np.stack([lwe.encrypt_lwe(p, ck.lwe_key, 1, ck.rng)
                    for _ in range(B)])
    weights = np.broadcast_to(mv_weights(p, key), (B, 16)).astype(np.int32)
    leader = np.arange(B, dtype=np.int32)
    bsk, ksk = server_key_device_arrays(sk)
    out = np.asarray(mv_pbs_batch(p, bsk, ksk, jnp.asarray(weights.copy()),
                                  jnp.asarray(leader),
                                  jnp.asarray(rot.view(np.int32))))
    # f(1) for or_and3 = 1 -> expected plaintext 1; measure phase error
    n = p.lwe_dimension
    with np.errstate(over="ignore"):
        phase = (out[:, n].view(np.uint32)
                 - (out[:, :n].view(np.uint32)
                    * ck.lwe_key[None, :].astype(np.uint32)).sum(
                        axis=1, dtype=np.uint32))
    err = ((phase.astype(np.int64) - p.delta + (1 << 31)) % (1 << 32)
           - (1 << 31))
    r = p.noise_budget_report()
    model = math.sqrt(u2 * r["std_blind_rotation"] ** 2
                      + r["std_keyswitch"] ** 2)
    emp = float(np.std(err))
    assert emp < 2.0 * model, (emp, model)
    # and it must actually be amplified vs a tight classic-only bound when
    # u2 is large (sanity that the measurement isn't trivially zero)
    assert emp > 0


def test_multivalue_sharded_mesh(keys):
    """Sharded mv levels: rotation batch sharded over an 8-virtual-device
    mesh, accumulators all-gathered, op outputs sharded — identical bits."""
    import jax

    from fhe_regex_tpu import decrypt, has_match, trivial_encrypt_str
    from fhe_regex_tpu.parallel.mesh import make_mesh

    ck, sk = keys
    mesh = make_mesh(len(jax.devices()))
    ct = trivial_encrypt_str(TEST_PARAMS, "bd")
    for pattern, want in [("/^[a-d][^xyz]$/", 1), ("/bd/", 1), ("/zz/", 0)]:
        res = has_match(sk, ct, pattern, backend="jnp", mesh=mesh,
                        multivalue=True)
        assert decrypt(ck, res) == want, pattern


def test_mv_dead_support_columns_dropped():
    """Level plans keep only the support positions their LUT factors touch
    (each kept column costs a full negacyclic roll at run time)."""
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import compile_circuit

    builder, root = compile_match(4, "/abc/", fold="tree")
    circuit = compile_circuit(TEST_PARAMS, builder, root, multivalue=True)
    S = len(mv_support_positions(TEST_PARAMS))
    for lv in circuit.levels:
        assert lv.mv_weights.shape[1] == len(lv.mv_positions) <= S
        assert lv.mv_weights.any(axis=0).all()   # no dead columns kept
    # eq/and levels touch only a handful of boundaries
    assert any(len(lv.mv_positions) < S for lv in circuit.levels)


def test_multivalue_run_many_sharded(keys):
    """Packed mv serving under a mesh: rotation chunks and op batches
    sharded, accumulators replicated into phase B."""
    import jax

    from fhe_regex_tpu import decrypt, trivial_encrypt_str
    from fhe_regex_tpu.ops.pbs import prepare_server_key
    from fhe_regex_tpu.parallel.mesh import make_mesh
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import Executor, compile_circuit

    ck, sk = keys
    mesh = make_mesh(len(jax.devices()))
    ex = Executor(TEST_PARAMS, prepare_server_key(TEST_PARAMS, sk, "jnp"),
                  mesh=mesh)
    builder, root = compile_match(2, "/^[a-d][^xyz]$/i", fold="tree")
    circuit = compile_circuit(TEST_PARAMS, builder, root,
                              min_bucket=mesh.devices.size, multivalue=True)
    contents = ["bq", "xq", "dd", "cz"]
    cts = np.stack([trivial_encrypt_str(TEST_PARAMS, c) for c in contents])
    res = ex.run_many(circuit, cts, wide_batch=False)
    assert [decrypt(ck, res[i]) for i in range(4)] == [1, 0, 1, 0]


@pytest.mark.parametrize("backend", ["int8", "jnp", "jnp64"])
def test_multivalue_on_backend(backend):
    """mv plans through every backend: the windowed/serving auto-mv path
    must run on whichever one is a width's default."""
    from fhe_regex_tpu import decrypt, has_match, trivial_encrypt_str
    from fhe_regex_tpu.crypto.keys import gen_keys
    from fhe_regex_tpu.params import TEST_PARAMS_64

    P = TEST_PARAMS_64 if backend == "jnp64" else TEST_PARAMS
    ck, sk = gen_keys(P, seed=17)
    for content, want in (("bd", 1), ("xz", 0)):
        res = has_match(sk, trivial_encrypt_str(P, content), "/^[a-d]d$/",
                        backend=backend, multivalue=True)
        assert decrypt(ck, res) == want, content
