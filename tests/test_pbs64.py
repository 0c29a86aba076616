"""64-bit-torus DEVICE path (ops/pbs64) vs the NumPy golden model.

The reference's tfhe-rs stack runs a 64-bit torus (SURVEY.md N1); here the
full PBS executes on device as 2 x int32 limb pairs with int8-limb
einsums.  Zero-noise params make every comparison bit-exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from fhe_regex_tpu.params import TEST_PARAMS_64 as P64
from fhe_regex_tpu.crypto import lwe
from fhe_regex_tpu.crypto.golden import make_lut_poly, pbs as golden_pbs
from fhe_regex_tpu.crypto.keys import gen_keys
from fhe_regex_tpu.ops import pbs64


@pytest.fixture(scope="module")
def keys64():
    return gen_keys(P64, seed=11)


def test_limb_pair_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 64, size=1000, dtype=np.uint64)
    lo, hi = pbs64.split64_np(x)
    assert np.array_equal(pbs64.join64_np(lo, hi), x)


def test_add_neg_shl_mod_2_64():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 64, size=500, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, size=500, dtype=np.uint64)
    alo, ahi = map(jnp.asarray, pbs64.split64_np(a))
    blo, bhi = map(jnp.asarray, pbs64.split64_np(b))
    s = pbs64.join64_np(*pbs64.add64(alo, ahi, blo, bhi))
    assert np.array_equal(s, a + b)                    # uint64 wraps mod 2^64
    n = pbs64.join64_np(*pbs64.neg64(alo, ahi))
    assert np.array_equal(n, np.uint64(0) - a)
    for sh in (0, 1, 7, 31, 32, 40, 63):
        got = pbs64.join64_np(*pbs64.shl64(alo, ahi, sh))
        assert np.array_equal(got, a << np.uint64(sh)), sh


def test_i32_to_64_shifted():
    rng = np.random.default_rng(2)
    p = rng.integers(-2**31, 2**31, size=500, dtype=np.int64).astype(np.int32)
    for sh in (0, 5, 24, 31, 32, 40):
        lo, hi = pbs64.i32_to_64_shifted(jnp.asarray(p), sh)
        got = pbs64.join64_np(lo, hi)
        want = (p.astype(np.int64) << sh).astype(np.uint64)  # wraps mod 2^64
        assert np.array_equal(got, want), sh


def test_decompose64_matches_golden():
    from fhe_regex_tpu.crypto.glwe import decompose_balanced

    rng = np.random.default_rng(3)
    v = rng.integers(0, 1 << 64, size=2048, dtype=np.uint64)
    lo, hi = map(jnp.asarray, pbs64.split64_np(v))
    for bl, lv in [(23, 1), (3, 5), (7, 3)]:
        got = np.asarray(pbs64.decompose64(lo, hi, bl, lv))
        want = decompose_balanced(v, bl, lv, torus_bits=64)
        assert np.array_equal(got, want), (bl, lv)


def test_digit_limbs_exact():
    rng = np.random.default_rng(4)
    d = rng.integers(-(1 << 22), (1 << 22) + 1, size=4096, dtype=np.int64)
    limbs = pbs64.digit_limbs_i8(jnp.asarray(d.astype(np.int32)), 3)
    rec = sum(np.asarray(l).astype(np.int64) << (8 * i)
              for i, l in enumerate(limbs))
    assert np.array_equal(rec, d)


def test_pbs64_bitexact_vs_golden(keys64):
    ck, sk = keys64
    f = lambda x: (3 * x + 5) % 16
    msgs = [0, 1, 5, 7, 12, 15, 3, 9]

    lut = make_lut_poly(P64, f)
    bsk8 = jnp.asarray(pbs64.prepare_bsk64(P64, sk.bsk))
    ksk8 = jnp.asarray(pbs64.prepare_ksk64(P64, sk.ksk))
    luts_lo, luts_hi = map(jnp.asarray, pbs64.split64_np(lut[None]))
    lut_idx = jnp.zeros(len(msgs), jnp.int32)

    cts = np.stack([lwe.encrypt_lwe(P64, ck.lwe_key, m, ck.rng) for m in msgs])
    cts_lo, cts_hi = map(jnp.asarray, pbs64.split64_np(cts))

    out_lo, out_hi = pbs64.pbs_batch64(P64, bsk8, ksk8, luts_lo, luts_hi,
                                       lut_idx, cts_lo, cts_hi)
    got_cts = pbs64.join64_np(np.asarray(out_lo), np.asarray(out_hi))

    for i, m in enumerate(msgs):
        want_ct = golden_pbs(P64, sk.bsk, sk.ksk, cts[i], lut)
        assert np.array_equal(got_cts[i], want_ct), m
        assert lwe.decrypt_lwe(P64, ck.lwe_key, got_cts[i]) == f(m)


def test_pbs64_noisy_decrypts():
    import dataclasses
    P = dataclasses.replace(P64, name="T64N", lwe_noise_std=float(2 ** 34),
                            glwe_noise_std=float(2 ** 20))
    ck, sk = gen_keys(P, seed=13)
    f = lambda x: (x + 1) % 16
    msgs = [0, 2, 9, 15]
    lut = make_lut_poly(P, f)
    bsk8 = jnp.asarray(pbs64.prepare_bsk64(P, sk.bsk))
    ksk8 = jnp.asarray(pbs64.prepare_ksk64(P, sk.ksk))
    luts_lo, luts_hi = map(jnp.asarray, pbs64.split64_np(lut[None]))
    cts = np.stack([lwe.encrypt_lwe(P, ck.lwe_key, m, ck.rng) for m in msgs])
    cts_lo, cts_hi = map(jnp.asarray, pbs64.split64_np(cts))
    out_lo, out_hi = pbs64.pbs_batch64(P, bsk8, ksk8, luts_lo, luts_hi,
                                       jnp.zeros(len(msgs), jnp.int32),
                                       cts_lo, cts_hi)
    got = pbs64.join64_np(np.asarray(out_lo), np.asarray(out_hi))
    for i, m in enumerate(msgs):
        assert lwe.decrypt_lwe(P, ck.lwe_key, got[i]) == f(m)


def test_has_match_64bit_end_to_end(keys64):
    """Full encrypted-regex pipeline at the reference's torus width: parser
    -> circuit -> level executor -> 64-bit limb-pair PBS -> decrypt."""
    from fhe_regex_tpu import decrypt, encrypt_str, has_match, trivial_encrypt_str

    ck, sk = keys64
    for content, pattern, want in [
        ("abc", "/b/", 1), ("abc", "/x/", 0),
        ("cdx", "/^cdxe?$/", 0),            # Q15 trailing-optional prune
        ("ab", "/a?b/", 1), ("abc", "/./", 1),
    ]:
        ct = trivial_encrypt_str(P64, content)
        res = has_match(sk, ct, pattern)
        assert res.dtype == np.uint64
        assert decrypt(ck, res) == want, (content, pattern)

    # real (keyed) encryption path too
    ct = encrypt_str(ck, "abc")
    assert decrypt(ck, has_match(sk, ct, "/ab/")) == 1
    assert decrypt(ck, has_match(sk, ct, "/ac/")) == 0


def test_reference_vectors_64bit(keys64):
    """All 25 reference bit-exactness vectors (engine.rs:256-280) at the
    reference's own torus width, through the 64-bit device pipeline."""
    from fhe_regex_tpu import decrypt, has_match, trivial_encrypt_str
    from tests.test_engine import REFERENCE_VECTORS

    ck, sk = keys64
    for content, pattern, exp in REFERENCE_VECTORS:
        ct = trivial_encrypt_str(P64, content)
        res = has_match(sk, ct, pattern, fold="tree")
        assert decrypt(ck, res) == exp, (content, pattern)


def test_has_match_64bit_sharded(keys64):
    """64-bit pipeline with the level batch sharded over the 8-device mesh."""
    from fhe_regex_tpu import decrypt, has_match, trivial_encrypt_str
    from fhe_regex_tpu.parallel.mesh import make_mesh

    ck, sk = keys64
    mesh = make_mesh(8)
    ct = trivial_encrypt_str(P64, "cdaabc")
    assert decrypt(ck, has_match(sk, ct, "/a*bc/", mesh=mesh, fold="tree")) == 1
    ct2 = trivial_encrypt_str(P64, "cdbc")
    assert decrypt(ck, has_match(sk, ct2, "/a+bc/", mesh=mesh, fold="tree")) == 0


def test_has_match_many_64bit(keys64):
    """Serving path (run_many limb-pair slabs) at the reference width."""
    from fhe_regex_tpu import decrypt, has_match_many, trivial_encrypt_str

    ck, sk = keys64
    contents = ["abcx", "xxxx", "xabc"]
    cts = np.stack([trivial_encrypt_str(P64, c) for c in contents])
    res = has_match_many(sk, cts, "/abc/")
    assert res.dtype == np.uint64
    assert [decrypt(ck, res[i]) for i in range(3)] == [1, 0, 1]


def test_multipattern_64bit(keys64):
    """Multi-root circuit at the reference's torus width: limb-pair slab,
    one root row per pattern."""
    from fhe_regex_tpu import decrypt, has_match_patterns, trivial_encrypt_str

    ck, sk = keys64
    ct = trivial_encrypt_str(P64, "abc")
    res = has_match_patterns(sk, ct, ["/b/", "/x/", "/^abc$/"])
    assert res.dtype == np.uint64 and res.shape[0] == 3
    assert [decrypt(ck, r) for r in res] == [1, 0, 1]
