"""64-bit-torus golden-model validation (reference tfhe-rs torus width, N1).

The primary execution path is the 32-bit torus; this suite proves the
crypto layer is torus-width-generic by running the full golden pipeline at
64 bits (the reference's width) on small parameters.
"""

import numpy as np
import pytest

from fhe_regex_tpu.params import TEST_PARAMS_64 as P64
from fhe_regex_tpu.crypto import lwe
from fhe_regex_tpu.crypto.glwe import (
    decompose_balanced,
    encrypt_ggsw_bit,
    encrypt_glwe,
    decrypt_glwe,
    external_product,
    negacyclic_polymul,
    recompose,
)
from fhe_regex_tpu.crypto.golden import make_lut_poly, pbs
from fhe_regex_tpu.crypto.keys import gen_keys


@pytest.fixture(scope="module")
def keys64():
    return gen_keys(P64, seed=11)


def test_decompose_64_roundtrip():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1 << 64, size=2048, dtype=np.uint64)
    for bl, lv in [(7, 3), (23, 1), (3, 5)]:
        d = decompose_balanced(v, bl, lv, torus_bits=64)
        rec = recompose(d, bl, lv, torus_bits=64)
        err = (rec - v).astype(np.int64)
        assert np.abs(err).max() <= 1 << (64 - bl * lv - 1)


def test_polymul_64_matches_32_structure():
    n = 16
    a = np.zeros(n, np.uint64)
    b = np.zeros(n, np.uint64)
    a[1] = 3
    b[n - 1] = np.uint64((1 << 63) + 5)
    out = negacyclic_polymul(a, b, torus_bits=64)
    # X * vX^{n-1} = -vX^n... coefficient 0 = -3v mod 2^64
    want = (-3 * ((1 << 63) + 5)) % (1 << 64)
    assert int(out[0]) == want
    assert np.all(out[1:] == 0)


def test_lwe_64_roundtrip(keys64):
    ck, _ = keys64
    for m in range(0, 16, 3):
        ct = lwe.encrypt_lwe(P64, ck.lwe_key, m, ck.rng)
        assert ct.dtype == np.uint64
        assert lwe.decrypt_lwe(P64, ck.lwe_key, ct) == m


def test_glwe_64_roundtrip(keys64):
    ck, _ = keys64
    M = (np.arange(P64.polynomial_size, dtype=np.uint64) % 16) * np.uint64(P64.delta)
    ct = encrypt_glwe(P64, ck.glwe_key, M, ck.rng)
    assert np.array_equal(decrypt_glwe(P64, ck.glwe_key, ct), M)


@pytest.mark.parametrize("bit", [0, 1])
def test_external_product_64(bit, keys64):
    ck, _ = keys64
    ggsw = encrypt_ggsw_bit(P64, ck.glwe_key, bit, ck.rng)
    M = np.zeros(P64.polynomial_size, np.uint64)
    M[0] = np.uint64(7 * P64.delta)
    ct = encrypt_glwe(P64, ck.glwe_key, M, ck.rng)
    phase = decrypt_glwe(P64, ck.glwe_key, external_product(P64, ggsw, ct))
    assert lwe.decode(P64, phase[0]) == (7 if bit else 0)


def test_pbs_64(keys64):
    ck, sk = keys64
    lut = make_lut_poly(P64, lambda x: (x * 3 + 2) % 16)
    assert lut.dtype == np.uint64
    for m in [0, 4, 9, 15]:
        ct = lwe.encrypt_lwe(P64, ck.lwe_key, m, ck.rng)
        out = pbs(P64, sk.bsk, sk.ksk, ct, lut)
        assert lwe.decrypt_lwe(P64, ck.lwe_key, out) == (m * 3 + 2) % 16


def test_ref64_margin_is_parameter_bound():
    """REF_MESSAGE_2_CARRY_2_64's sub-5-sigma margin is a property of the
    parameter point (keyswitch-key noise), NOT of this engine's combines:
    even tfhe-rs 0.2's own bivariate smart-op combine (4*lhs+rhs = 17x
    var_ct) stays under 5 sigma, so no carry-managed lowering can fix it.
    The stated 64-bit production contract is TPU64_MESSAGE_2_CARRY_2
    (params.py REF64 caveat; VERDICT round-1 item 2)."""
    import math

    from fhe_regex_tpu.params import (MIN_SIGMA_MARGIN,
                                      REF_MESSAGE_2_CARRY_2_64,
                                      TPU64_MESSAGE_2_CARRY_2)

    rep = REF_MESSAGE_2_CARRY_2_64.noise_budget_report()
    var_ct = rep["std_ciphertext"] ** 2
    var_ms = rep["std_modswitch"] ** 2
    # keyswitch dominates the stored-ciphertext noise at this set
    assert rep["std_keyswitch"] > 10 * rep["std_blind_rotation"]
    # the cheapest possible 2-input combine (tfhe-rs 0.2 bivariate) fails 5s
    tfhe_bivariate = rep["margin"] / math.sqrt(17 * var_ct + var_ms)
    assert 1.5 < tfhe_bivariate < MIN_SIGMA_MARGIN, tfhe_bivariate
    # ... while a bare PBS output is fine: the combine isn't free to avoid
    bare = rep["margin"] / math.sqrt(var_ct + var_ms)
    assert bare > MIN_SIGMA_MARGIN
    # the production 64-bit contract clears the bar at the worst combine
    assert (TPU64_MESSAGE_2_CARRY_2.noise_budget_report()["sigma_margin"]
            >= MIN_SIGMA_MARGIN)
