"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4: multi-host strategy tested via xla_force_host_platform_device_count).

Whether 8 devices are present is decided in a fixture, never at import:
xdist workers must all collect the same tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fhe_regex_tpu.params import TEST_PARAMS, TEST_PARAMS_NOISY
from fhe_regex_tpu.crypto import lwe
from fhe_regex_tpu.crypto.golden import make_lut_poly
from fhe_regex_tpu.ops.pbs import make_pbs_fn, prepare_server_key
from fhe_regex_tpu.parallel.mesh import make_mesh, make_sharded_pbs_fn


@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (tests/conftest.py forces 8 virtual "
                    "CPU devices)")


def test_sharded_pbs_matches_unsharded(keys):
    P = TEST_PARAMS
    ck, sk = keys
    dev_key = prepare_server_key(P, sk, "jnp")
    mesh = make_mesh(8)
    B = 16
    cts = np.stack([lwe.encrypt_lwe(P, ck.lwe_key, i % 16, ck.rng) for i in range(B)])
    luts = jnp.asarray(make_lut_poly(P, lambda x: (x + 5) % 16)[None].view(np.int32))
    idx = jnp.zeros(B, jnp.int32)
    ctsj = jnp.asarray(cts.view(np.int32))
    ref = make_pbs_fn(dev_key)(luts, idx, ctsj)
    shd = make_sharded_pbs_fn(dev_key, mesh)(luts, idx, ctsj)
    assert np.array_equal(np.asarray(ref), np.asarray(shd))


def test_has_match_on_mesh(keys):
    from fhe_regex_tpu import decrypt, has_match, trivial_encrypt_str
    P = TEST_PARAMS
    ck, sk = keys
    mesh = make_mesh(8)
    for content, pattern, exp in [("cdaabc", "/a*bc/", 1), ("abcd", "/^ab|cd$/", 0),
                                  ("Ab", "/ab/i", 1)]:
        ct = trivial_encrypt_str(P, content)
        res = has_match(sk, ct, pattern, mesh=mesh)
        assert decrypt(ck, res) == exp, (content, pattern)


def test_run_many_on_mesh(keys):
    """Serving fast path (run_many) with the level batch sharded across the
    8-device mesh, in both chunk plans."""
    from fhe_regex_tpu import decrypt, trivial_encrypt_str
    from fhe_regex_tpu.ops.pbs import prepare_server_key
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import (SMALL_LEVEL_BATCH, Executor,
                                              compile_circuit)

    P = TEST_PARAMS
    ck, sk = keys
    mesh = make_mesh(8)
    contents = ["xxabcxxx", "xxaqcxxx", "abcabcab", "xxxxxxxx"]
    want = [1, 0, 1, 0]
    builder, root = compile_match(8, "/abc/", P.num_blocks, fold="tree")
    circuit = compile_circuit(P, builder, root, min_bucket=SMALL_LEVEL_BATCH)
    ex = Executor(P, prepare_server_key(P, sk, "jnp"), mesh=mesh)
    cts = np.stack([trivial_encrypt_str(P, c) for c in contents])
    for wide in (False, True):
        res = ex.run_many(circuit, cts, wide_batch=wide)
        got = [decrypt(ck, res[i]) for i in range(len(contents))]
        assert got == want, (wide, got)


def test_dryrun_multichip():
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as g
    fn, args = g.entry()
    jax.jit(fn).lower(*args)  # lowering only: the full-size key is random


@pytest.mark.parametrize("n_dev", [2, 3, 6])
def test_tensor_parallel_bootstrap_bitexact(n_dev, keys):
    """TP inside one bootstrap: GGSW rows sharded + per-step psum == the
    single-device jnp path, bit-exactly (parallel/tensor.py)."""
    import jax.numpy as jnp

    from fhe_regex_tpu.crypto import lwe
    from fhe_regex_tpu.crypto.golden import make_lut_poly
    from fhe_regex_tpu.ops.pbs import make_pbs_fn, prepare_server_key
    from fhe_regex_tpu.parallel.tensor import make_tp_mesh, make_tp_pbs_fn

    params = TEST_PARAMS
    ck, sk = keys
    f = lambda x: (x * 5 + 3) % 16
    msgs = [0, 1, 7, 15, 9, 4, 2, 11]
    cts = np.stack([lwe.encrypt_lwe(params, ck.lwe_key, m, ck.rng)
                    for m in msgs])
    luts = jnp.asarray(np.stack([make_lut_poly(params, f)]).view(np.int32))
    idx = jnp.zeros(len(msgs), jnp.int32)
    ctsj = jnp.asarray(cts.view(np.int32))

    ref = make_pbs_fn(prepare_server_key(params, sk, "jnp"))(luts, idx, ctsj)
    tp = make_tp_pbs_fn(params, sk, make_tp_mesh(n_dev))(luts, idx, ctsj)
    assert np.array_equal(np.asarray(ref), np.asarray(tp))
    o = np.asarray(tp).view(np.uint32)
    got = [lwe.decrypt_lwe(params, ck.lwe_key, o[i]) for i in range(len(msgs))]
    assert got == [f(m) % 16 for m in msgs]


def test_tensor_parallel_rejects_bad_mesh(keys):
    from fhe_regex_tpu.parallel.tensor import make_tp_mesh, make_tp_pbs_fn

    _, sk = keys
    with pytest.raises(ValueError):
        make_tp_pbs_fn(TEST_PARAMS, sk, make_tp_mesh(4))


def test_make_mesh_rejects_oversized_request():
    """A mesh bigger than the visible devices must fail loudly — a silently
    smaller mesh changes collective semantics (a 1-device OR-tree is the
    identity)."""
    from fhe_regex_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="device"):
        make_mesh(len(jax.devices()) + 1)


# ---- default backends x mesh composition, production geometry ----
#
# The (backend, params) pairs that run on a multi-card host are the width
# defaults (ops/pbs.DEFAULT_BACKEND) at the production GLWE geometry
# (N=2048, k=1, l=3, base 2^7 at 32 bits; N=2048, l=1, base 2^23 at 64
# bits — what shapes every negacyclic matrix and limb product); only the
# CMUX step count n is shrunk (866 -> 16) to bound CPU runtime.  The full-n
# production shapes themselves are exercised by dryrun_multichip (jnp
# backend, real keys) and by chip_smoke.py on the card.

import dataclasses


def _prod_shape_params():
    from fhe_regex_tpu.params import TPU_MESSAGE_2_CARRY_2
    return dataclasses.replace(
        TPU_MESSAGE_2_CARRY_2, name="TEST_PROD_SHAPE",
        lwe_dimension=16, lwe_noise_std=0.0, glwe_noise_std=0.0)


@pytest.mark.parametrize("backend", ["int8", "jnp"])
def test_sharded_fused_kernel_production_geometry(backend):
    """The 32-bit routes (the int8 default and the jnp spec path) under
    shard_map on a 2-device mesh at the production N=2048 geometry,
    decrypt-gated."""
    from fhe_regex_tpu.crypto.keys import gen_keys
    from fhe_regex_tpu.ops.pbs import key_arrays

    P = _prod_shape_params()
    ck, sk = gen_keys(P, seed=7)
    dev_key = prepare_server_key(P, sk, backend)
    mesh = make_mesh(2)
    from fhe_regex_tpu.parallel.mesh import make_sharded_pbs_core
    core = make_sharded_pbs_core(dev_key, mesh)

    B = 8
    f = lambda x: (x * 3 + 1) % 16
    msgs = [i % 16 for i in range(B)]
    cts = np.stack([lwe.encrypt_lwe(P, ck.lwe_key, m, ck.rng) for m in msgs])
    luts = jnp.asarray(make_lut_poly(P, f)[None].view(np.int32))
    idx = jnp.zeros(B, jnp.int32)
    out = jax.jit(core)(key_arrays(dev_key), luts, idx,
                        jnp.asarray(cts.view(np.int32)))
    o = np.asarray(out).view(np.uint32)
    got = [lwe.decrypt_lwe(P, ck.lwe_key, o[i]) for i in range(B)]
    assert got == [f(m) for m in msgs], got


def test_sharded_fused64_kernel_production_geometry():
    """The 64-bit route (jnp64) under shard_map at the reference set's
    N=2048 / l=1 / base 2^23 geometry."""
    from fhe_regex_tpu.crypto.keys import gen_keys
    from fhe_regex_tpu.ops.pbs import key_arrays
    from fhe_regex_tpu.params import REF_MESSAGE_2_CARRY_2_64
    from fhe_regex_tpu.parallel.mesh import make_sharded_pbs_core
    from fhe_regex_tpu.regex.executor import _np_to_limbs

    P = dataclasses.replace(
        REF_MESSAGE_2_CARRY_2_64, name="TEST_PROD_SHAPE_64",
        lwe_dimension=16, lwe_noise_std=0.0, glwe_noise_std=0.0)
    ck, sk = gen_keys(P, seed=9)
    dev_key = prepare_server_key(P, sk, "jnp64")
    mesh = make_mesh(2)
    core = make_sharded_pbs_core(dev_key, mesh)

    B = 8
    f = lambda x: (x + 5) % 16
    msgs = [i % 16 for i in range(B)]
    cts = np.stack([lwe.encrypt_lwe(P, ck.lwe_key, m, ck.rng) for m in msgs])
    luts = jnp.asarray(_np_to_limbs(make_lut_poly(P, f)[None], 64))
    idx = jnp.zeros(B, jnp.int32)
    out = jax.jit(core)(key_arrays(dev_key), luts, idx,
                        jnp.asarray(_np_to_limbs(cts, 64)))
    o = np.asarray(out).copy().view(np.int64).view(np.uint64)[..., 0]
    got = [lwe.decrypt_lwe(P, ck.lwe_key, o[i]) for i in range(B)]
    assert got == [f(m) for m in msgs], got
