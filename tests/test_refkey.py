"""Cross-validation against the reference's own key fixture.

``/root/reference/test_data/client_key`` is the one ground-truth tfhe-rs
artifact shipped with the reference (bincode ``RadixClientKey``, written by
engine.rs:238-246, loaded by engine.rs:248-254).  These tests close SURVEY.md
N1's re-verification promise: the ``REF_MESSAGE_2_CARRY_2_64`` parameter pins
are asserted field-by-field against the values *extracted from the fixture*
(not public-docs tables), and encryption/decryption — and, in the slow gated
test, a full programmable bootstrap — run under the reference's actual
secret keys.

The full 25-vector end-to-end run under the reference's keys is a hardware
job (benchmarks/refkey_vectors.py).
"""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

from fhe_regex_tpu.crypto import lwe as L
from fhe_regex_tpu.crypto.refkey import (
    REFERENCE_FIXTURE,
    client_key_from_fixture,
    params_from_fixture,
    parse_radix_client_key,
)
from fhe_regex_tpu.params import REF_MESSAGE_2_CARRY_2_64

pytestmark = pytest.mark.skipif(
    not REFERENCE_FIXTURE.exists(),
    reason="reference key fixture not present in this environment",
)


@pytest.fixture(scope="module")
def ref():
    return parse_radix_client_key()


def test_parse_consumes_exactly_and_is_structurally_sound(ref):
    # exact-byte-consumption + binariness + dim consistency are enforced
    # inside the parser; re-assert the headline facts here.
    assert ref.parameters.lwe_dimension == len(ref.small_lwe_key) == 742
    assert ref.glwe_key.shape == (1, 2048)
    assert ref.num_blocks == 4
    # the big (pre-keyswitch) LWE key IS the flattened GLWE key — the
    # sample-extract identity tfhe-rs relies on, visible in the fixture
    np.testing.assert_array_equal(ref.big_lwe_key, ref.glwe_key.ravel())
    # plausible Hamming weights for uniform binary keys (binomial 5-sigma)
    assert abs(int(ref.big_lwe_key.sum()) - 1024) < 5 * np.sqrt(2048 / 4)
    assert abs(int(ref.small_lwe_key.sum()) - 371) < 5 * np.sqrt(742 / 4)


def test_fixture_parameters_equal_the_pinned_values(ref):
    """THE N1 re-verification: every pinned value vs the fixture's own."""
    p = ref.parameters
    assert p.lwe_dimension == 742
    assert p.glwe_dimension == 1
    assert p.polynomial_size == 2048
    assert p.lwe_modular_std_dev == 7.069849454709433e-06   # exact f64 bits
    assert p.glwe_modular_std_dev == 2.9403601535432533e-16
    assert (p.pbs_base_log, p.pbs_level) == (23, 1)
    assert (p.ks_base_log, p.ks_level) == (3, 5)
    assert (p.message_modulus, p.carry_modulus) == (4, 4)
    # and the derived Params object is field-for-field our registry entry
    derived = params_from_fixture(ref)
    for f in dataclasses.fields(derived):
        if f.name == "name":
            continue
        assert getattr(derived, f.name) == getattr(REF_MESSAGE_2_CARRY_2_64, f.name), \
            f"pin mismatch on {f.name}"


def test_encrypt_decrypt_under_reference_secret_key():
    """Radix encrypt/decrypt with REAL noise under the reference's key."""
    ck, _ = client_key_from_fixture(seed=1234)
    p = ck.params
    for byte in b"abcXYZ019~\x00\x7f":
        ct = L.encrypt_byte(p, ck.lwe_key, byte, ck.rng)
        assert L.decrypt_byte(p, ck.lwe_key, ct) == byte
    # trivial ciphertexts decrypt under any key, including this one
    assert L.decrypt_byte(p, ck.lwe_key, L.trivial_byte(p, ord("q"))) == ord("q")


def test_mask_nonzero_under_reference_key():
    """Guard against silently encrypting trivially (zero mask)."""
    ck, _ = client_key_from_fixture(seed=99)
    ct = L.encrypt_byte(ck.params, ck.lwe_key, ord("a"), ck.rng)
    assert np.count_nonzero(ct[:, :-1]) > ct.shape[0] * (ct.shape[1] - 1) * 0.9


@pytest.mark.skipif(os.environ.get("FHE_REGEX_SLOW_TESTS") != "1",
                    reason="~60 s: full-parameter golden PBS on CPU "
                           "(set FHE_REGEX_SLOW_TESTS=1)")
def test_full_pbs_under_reference_keys():
    """Derive bsk/ksk from the reference's secrets (ServerKey::new,
    engine.rs:252) and run one full golden-model bootstrap at the
    reference's exact 64-bit parameter point."""
    from fhe_regex_tpu.crypto import golden
    from fhe_regex_tpu.crypto.keys import server_key_from_client

    ck, _ = client_key_from_fixture(seed=7)
    p = ck.params
    sk = server_key_from_client(ck)
    lut = golden.make_lut_poly(p, lambda m: int(m == 2))
    for m, exp in ((2, 1), (1, 0)):
        ct = L.encrypt_lwe(p, ck.lwe_key, m, ck.rng)
        out = golden.pbs(p, sk.bsk, sk.ksk, ct, lut)
        assert L.decrypt_lwe(p, ck.lwe_key, out) == exp
