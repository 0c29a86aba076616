"""Multi-value bootstrap runtime: one blind rotation, many LUT outputs.

Every test polynomial factors exactly as u (*) v over the negacyclic ring
(ops/luts.py ``mv_weights``; spec in crypto/golden.py), and blind rotation
commutes with multiplication by a fixed poly — so ops that share an input
share ONE rotation of the common v, and each op's LUT is applied at
sample-extract time as a cheap static-roll combination:

    big_j = sum_m  u_j[m] * sample_extract(X^{p_m} * acc_v)

The support positions p_m are STATIC (window boundaries), so the combine is
16 static negacyclic rolls + a weighted sum — elementwise glue around the
same blind rotations and keyswitch matmuls the classic path uses.

Cost model: the blind rotation is nearly all of a bootstrap's work, so a
level with R unique inputs among W ops does R/W of the rotation work.
Compiled regex circuits share 20-43% of their rotations on
class/alternation patterns (tests/test_multivalue.py).

Noise: derived outputs amplify the blind-rotation noise component by
||u||_2^2 <= 12 (production LUTs); keyswitch + modswitch dominate at our
parameters, so the worst-case margin stays >= 5 sigma
(params.noise_budget_report(mv_norm2=...), asserted in tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fhe_regex_tpu.crypto.golden import mv_testpoly
from fhe_regex_tpu.ops.luts import mv_support_positions
from fhe_regex_tpu.ops.pbs import (
    DeviceServerKey,
    blind_rotate,
    blind_rotate_int8,
    key_switch,
    key_switch_limbs,
    mod_switch,
    sample_extract,
)
from fhe_regex_tpu.params import Params

I32 = jnp.int32

MV_BACKENDS = ("jnp", "int8", "jnp64")


def mv_lut_table(params: Params) -> np.ndarray:
    """The 1-row LUT table every multi-value rotation uses (v).

    32-bit: [1, N] uint32 view; 64-bit: [1, N, 2] int32 limb pairs (the
    executor's device LUT convention)."""
    v = mv_testpoly(params)[None]
    if params.torus_bits == 32:
        return v
    from fhe_regex_tpu.ops.pbs64 import split64_np
    lo, hi = split64_np(v)
    return np.stack([lo, hi], axis=-1)


def _rotate_acc(dev_key: DeviceServerKey, key, vlut, cts):
    """Backend dispatch: affine-combined cts -> accumulators.

    32-bit: cts [R, n+1] -> [R, k+1, N]; 64-bit: cts [R, n+1, 2] limb
    pairs -> [R, k+1, N, 2]."""
    params = dev_key.params
    backend = dev_key.backend
    idx = jnp.zeros(cts.shape[0], I32)
    if backend == "jnp64":
        from fhe_regex_tpu.ops import pbs64 as p64
        ms = p64.mod_switch64(params, cts[..., 0], cts[..., 1])
        lo, hi = p64.blind_rotate64(params, key[0], vlut[..., 0],
                                    vlut[..., 1], idx, ms)
        return jnp.stack([lo, hi], axis=-1)       # [R, k+1, N, 2]
    cts_ms = mod_switch(params, cts)
    if backend == "jnp":
        return blind_rotate(params, key[0], vlut, idx, cts_ms)
    if backend == "int8":
        return blind_rotate_int8(params, key[0], vlut, idx, cts_ms)
    raise ValueError(f"multi-value bootstrap not supported on {backend!r}")


def _key_switch(dev_key: DeviceServerKey, key, big):
    params = dev_key.params
    if dev_key.backend == "jnp64":
        from fhe_regex_tpu.ops.pbs64 import key_switch64
        out_lo, out_hi = key_switch64(params, key[1], big[..., 0],
                                      big[..., 1])
        return jnp.stack([out_lo, out_hi], axis=-1)
    if dev_key.backend == "jnp":
        return key_switch(params, key[1], big)
    return key_switch_limbs(params, key[1], big)


def mv_extract(params: Params, accs, weights, leader, positions=None):
    """Derived big-LWEs from shared accumulators.

    accs [R, k+1, N]; weights [W, S] int32 (S support positions);
    leader [W] int32 row of each op's rotation.  -> [W, kN+1] int32.

    positions: static tuple of support coefficient positions matching
    weights' columns (default: the full production support) — level plans
    pass only the columns with any nonzero weight, skipping dead rolls.
    """
    pos = mv_support_positions(params) if positions is None else positions
    big = None
    for m, p in enumerate(pos):
        w_m = weights[:, m]
        # X^{p} * acc: static negacyclic roll (sign flip on wraparound)
        rolled = jnp.roll(accs, int(p), axis=-1)
        rolled = rolled.at[..., :int(p)].multiply(-1)
        se = sample_extract(params, rolled)                  # [R, kN+1]
        term = w_m[:, None] * se[leader]                     # [W, kN+1]
        big = term if big is None else big + term
    return big


def mv_extract64(params: Params, accs, weights, leader, positions=None):
    """64-bit derived big-LWEs: accs [R, k+1, N, 2] int32 limb pairs ->
    [W, kN+1, 2] (carry-exact weighted sums; |weights| < 32 — enforced,
    since the 5-bit shift-add loop below would silently drop higher
    weight bits)."""
    from fhe_regex_tpu.ops import pbs64 as p64

    if isinstance(weights, np.ndarray):
        assert np.abs(weights).max(initial=0) < 32, (
            "mv_extract64 supports |weights| < 32 (5-bit shift-add); got "
            f"max |w| = {np.abs(weights).max()}")
    pos = mv_support_positions(params) if positions is None else positions
    big_lo = big_hi = None
    for m, p in enumerate(pos):
        p = int(p)
        rlo = jnp.roll(accs[..., 0], p, axis=-1)
        rhi = jnp.roll(accs[..., 1], p, axis=-1)
        nlo, nhi = p64.neg64(rlo[..., :p], rhi[..., :p])
        rlo = rlo.at[..., :p].set(nlo)
        rhi = rhi.at[..., :p].set(nhi)
        se_lo, se_hi = p64.sample_extract64(params, rlo, rhi)  # [R, kN+1]
        g_lo, g_hi = se_lo[leader], se_hi[leader]              # [W, kN+1]
        w_m = weights[:, m][:, None]
        aw = jnp.abs(w_m)
        plo = jnp.zeros_like(g_lo)
        phi = jnp.zeros_like(g_hi)
        for b in range(5):                 # w*x = sum_b bit_b(|w|)*(x << b)
            sl, sh = (g_lo, g_hi) if b == 0 else p64.shl64(g_lo, g_hi, b)
            on = ((aw >> b) & 1).astype(bool)
            tlo = jnp.where(on, sl, 0)
            thi = jnp.where(on, sh, 0)
            plo, phi = p64.add64(plo, phi, tlo, thi)
        nlo2, nhi2 = p64.neg64(plo, phi)
        plo = jnp.where(w_m < 0, nlo2, plo)
        phi = jnp.where(w_m < 0, nhi2, phi)
        if big_lo is None:
            big_lo, big_hi = plo, phi
        else:
            big_lo, big_hi = p64.add64(big_lo, big_hi, plo, phi)
    return jnp.stack([big_lo, big_hi], axis=-1)


def _check_mv(dev_key: DeviceServerKey) -> None:
    if dev_key.backend not in MV_BACKENDS:
        raise ValueError(
            f"multi-value bootstrap not supported on {dev_key.backend!r}")


def make_mv_rotate_core(dev_key: DeviceServerKey):
    """(key_args, vlut, rot_cts) -> accumulators.

    32-bit: rot_cts [R, n+1] -> [R, k+1, N]; 64-bit: rot_cts [R, n+1, 2]
    limb pairs -> [R, k+1, N, 2]."""
    _check_mv(dev_key)

    def core(key, vlut, rot_cts):
        return _rotate_acc(dev_key, key, vlut, rot_cts)

    return core


def make_mv_finish_core(dev_key: DeviceServerKey):
    """(key_args, accs, weights, leader, positions=None) ->
    [W, n+1(, 2)] derived outputs.  `positions` must be a STATIC tuple
    (it selects which negacyclic rolls are emitted)."""
    _check_mv(dev_key)
    params = dev_key.params
    extract = mv_extract if params.torus_bits == 32 else mv_extract64

    def core(key, accs, weights, leader, positions=None):
        big = extract(params, accs, weights, leader, positions)
        return _key_switch(dev_key, key, big)

    return core


def make_mv_core(dev_key: DeviceServerKey):
    """(key_args, vlut, weights, leader, rot_cts) -> [W, n+1] outputs.

    rot_cts [R, n+1]: the DEDUPED affine-combined inputs (one per unique
    rotation); every op's output is derived from its leader's accumulator.
    Pair with ops.pbs.key_arrays(dev_key), as make_pbs_core.
    """
    rotate = make_mv_rotate_core(dev_key)
    finish = make_mv_finish_core(dev_key)

    def core(key, vlut, weights, leader, rot_cts, positions=None):
        return finish(key, rotate(key, vlut, rot_cts), weights, leader,
                      positions)

    return core


@functools.partial(jax.jit, static_argnums=0)
def mv_pbs_batch(params: Params, bsk, ksk, weights, leader, rot_cts):
    """jnp-path multi-value PBS (tests / reference)."""
    ms = mod_switch(params, rot_cts)
    vlut = jnp.asarray(mv_lut_table(params).view(np.int32))
    accs = blind_rotate(params, bsk, vlut, jnp.zeros(rot_cts.shape[0], I32), ms)
    big = mv_extract(params, accs, weights, leader)
    return key_switch(params, ksk, big)
