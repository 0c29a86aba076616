"""Tests that need the GPU: the exact routes as the card's compiler builds
them, at the production GLWE geometry (n cut to 16), bit-exact against the
jnp specification path and the golden model.  They skip elsewhere; on the
card: FHE_REGEX_CARD_TESTS=1 python -m pytest tests/ -m card"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from fhe_regex_tpu.crypto import lwe
from fhe_regex_tpu.crypto.golden import make_lut_poly, pbs as golden_pbs
from fhe_regex_tpu.crypto.keys import gen_keys
from fhe_regex_tpu.ops.pbs import make_pbs_fn, prepare_server_key
from fhe_regex_tpu.params import (REF_MESSAGE_2_CARRY_2_64,
                                  TPU_MESSAGE_2_CARRY_2)
from fhe_regex_tpu.regex.executor import _limbs_to_np, _np_to_limbs

pytestmark = pytest.mark.card


def _shape(params, name):
    return dataclasses.replace(params, name=name, lwe_dimension=16,
                               lwe_noise_std=0.0, glwe_noise_std=0.0)


@pytest.mark.parametrize("route,params", [
    ("int8", _shape(TPU_MESSAGE_2_CARRY_2, "CARD_SHAPE_32")),

    ("jnp64", _shape(REF_MESSAGE_2_CARRY_2_64, "CARD_SHAPE_64")),
], ids=["int8", "jnp64"])
def test_exact_route_on_the_card(card, route, params):
    ck, sk = gen_keys(params, seed=31)
    tb = params.torus_bits
    f = lambda x: (7 * x + 2) % 16
    msgs = list(range(16)) * 4
    lut = make_lut_poly(params, f)
    luts = jnp.asarray(_np_to_limbs(lut[None], tb))
    idx = jnp.zeros(len(msgs), jnp.int32)
    cts = np.stack([lwe.encrypt_lwe(params, ck.lwe_key, m, ck.rng)
                    for m in msgs])
    ctsj = jnp.asarray(_np_to_limbs(cts, tb))
    got = make_pbs_fn(prepare_server_key(params, sk, route))(
        luts, idx, ctsj)
    assert got.devices() == {card}
    got = _limbs_to_np(np.asarray(got), tb)
    if tb == 32:
        ref = _limbs_to_np(np.asarray(make_pbs_fn(
            prepare_server_key(params, sk, "jnp"))(luts, idx, ctsj)), tb)
        assert np.array_equal(got, ref)
    assert np.array_equal(got[0], golden_pbs(params, sk.bsk, sk.ksk,
                                             cts[0], lut))
    assert [lwe.decrypt_lwe(params, ck.lwe_key, got[i])
            for i in range(len(msgs))] == [f(m) for m in msgs]
