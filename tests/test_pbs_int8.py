"""The int8 limb-split route and the backend table (ops/pbs.py).

The int8 route computes each CMUX external product as ONE s8 x s8 -> s32
matrix product over 4 signed 8-bit key limbs; it must be bit-exact against
the int32 jnp specification path and the NumPy golden model.  At 64 bits
the same limb algebra is the jnp64 route (ops/pbs64.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fhe_regex_tpu.crypto import lwe
from fhe_regex_tpu.crypto.golden import make_lut_poly, pbs as golden_pbs
from fhe_regex_tpu.crypto.keys import gen_keys
from fhe_regex_tpu.ops import pbs as pbs_mod
from fhe_regex_tpu.ops.pbs import (BACKENDS, DEFAULT_BACKEND, make_pbs_fn,
                                   prepare_server_key, resolve_backend)
from fhe_regex_tpu.params import (TEST_PARAMS, TEST_PARAMS_64,
                                  TEST_PARAMS_NOISY, TPU_MESSAGE_2_CARRY_2,
                                  TPU64_MESSAGE_2_CARRY_2)
from fhe_regex_tpu.regex.executor import _limbs_to_np, _np_to_limbs

from test_engine import REFERENCE_VECTORS

# production GLWE geometry (N=2048, k=1, l=3, base 2^7) with the CMUX step
# count cut to 16 so a CPU run stays short
PROD_SHAPE = dataclasses.replace(
    TPU_MESSAGE_2_CARRY_2, name="TEST_PROD_SHAPE_INT8", lwe_dimension=16,
    lwe_noise_std=0.0, glwe_noise_std=0.0)


@pytest.mark.parametrize("params", [TEST_PARAMS, TEST_PARAMS_NOISY,
                                    TEST_PARAMS_64, PROD_SHAPE],
                         ids=lambda p: p.name)
def test_int8_route_bitexact_vs_jnp_and_golden(params):
    """The width's int8 limb route == the exact reference path == golden."""
    ck, sk = gen_keys(params, seed=23)
    f = lambda x: (5 * x + 3) % 16
    msgs = [0, 1, 6, 7, 12, 15, 3, 9]
    tb = params.torus_bits
    lut = make_lut_poly(params, f)
    luts = jnp.asarray(_np_to_limbs(lut[None], tb))
    idx = jnp.zeros(len(msgs), jnp.int32)
    cts = np.stack([lwe.encrypt_lwe(params, ck.lwe_key, m, ck.rng)
                    for m in msgs])
    ctsj = jnp.asarray(_np_to_limbs(cts, tb))
    route = "int8" if tb == 32 else "jnp64"
    got = _limbs_to_np(np.asarray(make_pbs_fn(
        prepare_server_key(params, sk, route))(luts, idx, ctsj)), tb)
    if tb == 32:
        ref = _limbs_to_np(np.asarray(make_pbs_fn(
            prepare_server_key(params, sk, "jnp"))(luts, idx, ctsj)), tb)
        assert np.array_equal(got, ref)
    for i in range(2):
        assert np.array_equal(got[i], golden_pbs(params, sk.bsk, sk.ksk,
                                                 cts[i], lut)), i
    assert [lwe.decrypt_lwe(params, ck.lwe_key, got[i])
            for i in range(len(msgs))] == [f(m) for m in msgs]


def test_prepare_bsk_int8_limbs_recombine_to_the_doubled_key():
    rng = np.random.default_rng(5)
    P = TEST_PARAMS
    k1, rows, N = 2, 6, P.polynomial_size
    bsk = rng.integers(0, 2**32, size=(3, rows, k1, N), dtype=np.uint32)
    q = pbs_mod.prepare_bsk_int8(P, bsk)
    assert q.shape == (3, rows, 2 * N, k1, 4) and q.dtype == np.int8
    rec = sum(q[..., j].astype(np.int64) << (8 * j) for j in range(4))
    rec = np.swapaxes(rec & 0xFFFFFFFF, 2, 3).astype(np.uint32)
    g = bsk.view(np.int32).astype(np.int64)
    doubled = (np.concatenate([g, -g], axis=-1) & 0xFFFFFFFF).astype(np.uint32)
    assert np.array_equal(rec, doubled)


def test_prepare_bsk_int8_rejects_digits_wider_than_int8():
    P = dataclasses.replace(TEST_PARAMS, name="WIDE_DIGITS",
                            pbs_base_log=8, pbs_level=2)
    bsk = np.zeros((1, 4, 2, P.polynomial_size), np.uint32)
    with pytest.raises(ValueError, match="int8"):
        pbs_mod.prepare_bsk_int8(P, bsk)


@pytest.mark.parametrize("content,pattern,exp", REFERENCE_VECTORS,
                         ids=[f"{c}~{p}" for c, p, _ in REFERENCE_VECTORS])
def test_reference_vectors_default_backend_executor(content, pattern, exp,
                                                    noisy_keys):
    """All 25 reference vectors through the level executor on the 32-bit
    default backend, with real (noisy) client encryption."""
    from fhe_regex_tpu import decrypt, encrypt_str
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import Executor, compile_circuit

    ck, sk = noisy_keys
    P = TEST_PARAMS_NOISY
    dev_key = prepare_server_key(P, sk)
    assert dev_key.backend == DEFAULT_BACKEND[32]
    builder, root = compile_match(len(content), pattern, P.num_blocks,
                                  fold="tree")
    circuit = compile_circuit(P, builder, root)
    res = Executor(P, dev_key).run(circuit, encrypt_str(ck, content))
    assert decrypt(ck, res) == exp


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_resolve_backend_has_no_platform_branch(platform, monkeypatch):
    """The default depends on the torus width only — never on the
    platform JAX runs on."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert resolve_backend(None, TPU_MESSAGE_2_CARRY_2) == DEFAULT_BACKEND[32]
    assert resolve_backend(None, TPU64_MESSAGE_2_CARRY_2) == DEFAULT_BACKEND[64]
    assert resolve_backend(None) == DEFAULT_BACKEND[32]


def test_resolve_backend_names():
    assert set(BACKENDS) == {"jnp", "int8", "jnp64"}
    assert DEFAULT_BACKEND[32] in BACKENDS and DEFAULT_BACKEND[64] in BACKENDS
    for name in BACKENDS:
        assert resolve_backend(name) == name
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas")
    _, sk = gen_keys(TEST_PARAMS, seed=3)
    with pytest.raises(ValueError, match="64-bit"):
        prepare_server_key(TEST_PARAMS, sk, "jnp64")
