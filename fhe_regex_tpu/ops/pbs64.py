"""64-bit-torus device PBS — the reference's torus width (SURVEY.md N1, N9).

Torus values live on device as two int32 limb arrays ``(lo, hi)`` (bits
0-31 / 32-63) with explicit carry arithmetic, so no process-wide
``jax_enable_x64`` is needed; all adds/negations are exact mod 2^64.

The external product uses the same limb-matmul formulation as the 32-bit
int8 route (ops/pbs.py blind_rotate_int8): GGSW polynomials are split host-side into
EIGHT signed 8-bit limbs *after* doubling to (g, -g mod 2^64) — negation is
applied on the torus value before the limb split, so device code never
negates an int8 limb (-128 would overflow).  Gadget digits (|d| < 2^22 at
the reference's base_log=23) split into three signed 8-bit limbs on device.
Every (digit-limb i, key-limb j) pair is one int8 einsum with int32
accumulation (exact: |products| <= 2^14, row sums <= 2^25), and the 24
partials recombine at weights 2^{8(i+j)} into (lo, hi) with carry-correct
shifts — exact arithmetic mod 2^64 by construction.

This is the 64-bit width's only route (``jnp64``), at every parameter
set; a fused kernel for full-parameter 64-bit throughput can reuse the
identical limb algebra.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fhe_regex_tpu.params import Params

I32 = jnp.int32
U32 = jnp.uint32


# ---------------- (lo, hi) int32-pair arithmetic, exact mod 2^64 ----------


def split64_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint64 host array -> (lo, hi) int32 arrays."""
    v = np.ascontiguousarray(x.astype(np.uint64))
    return ((v & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
            (v >> np.uint64(32)).astype(np.uint32).view(np.int32))


def join64_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) int32 host arrays -> uint64."""
    return (np.asarray(lo).view(np.uint32).astype(np.uint64)
            | (np.asarray(hi).view(np.uint32).astype(np.uint64) << np.uint64(32)))


def add64(alo, ahi, blo, bhi):
    lo = alo + blo
    carry = (lo.astype(U32) < alo.astype(U32)).astype(I32)
    return lo, ahi + bhi + carry


def neg64(lo, hi):
    return -lo, -hi - (lo != 0).astype(I32)


def shl64(lo, hi, s: int):
    """V * 2^s mod 2^64 for static 0 <= s < 64."""
    if s == 0:
        return lo, hi
    if s < 32:
        nhi = (hi << s) | (lo.astype(U32) >> (32 - s)).astype(I32)
        return lo << s, nhi
    return jnp.zeros_like(lo), lo << (s - 32)


def i32_to_64_shifted(p, s: int):
    """64-bit value p * 2^s (p signed int32, static 0 <= s < 64) as (lo, hi)."""
    if s == 0:
        return p, p >> 31                       # sign extension
    if s < 32:
        return p << s, p >> (32 - s)            # arithmetic shift: sign-correct
    return jnp.zeros_like(p), p << (s - 32)


# ---------------- rounding/decomposition (top-bits-only helpers) ----------


def _rounded_top(lo, hi, shift: int):
    """(V + 2^(shift-1)) >> shift for static shift >= 33 (top 31 bits of V
    rounded; the carry add touches only the hi limb)."""
    assert shift >= 33, "top-bit helpers need base_log*level <= 31"
    hi2 = hi + (1 << (shift - 1 - 32))
    return (hi2.astype(U32) >> (shift - 32)).astype(I32)


def mod_switch64(params: Params, lo, hi):
    """[B, n+1] torus pairs -> values in [0, 2N)."""
    N = params.polynomial_size
    shift = params.torus_bits - (N.bit_length() - 1) - 1
    return _rounded_top(lo, hi, shift) & (2 * N - 1)


def decompose64(v_lo, v_hi, base_log: int, level: int, torus_bits: int = 64):
    """Balanced gadget digits from (lo, hi) pairs, most-significant first.

    Mirrors crypto/glwe.decompose_balanced at 64 bits; requires
    base_log*level <= 31 (true for the reference's PBS 23x1 and KS 3x5)."""
    shift = torus_bits - base_log * level
    state = _rounded_top(v_lo, v_hi, shift)
    B = 1 << base_log
    half = B // 2
    digits = []
    for _ in range(level):
        d = state & (B - 1)
        d = jnp.where(d >= half, d - B, d)
        state = (state - d) >> base_log
        digits.append(d)
    return jnp.stack(digits[::-1])


def digit_limbs_i8(d, n_limbs: int):
    """Signed int32 digits -> list of n_limbs int8 limb arrays (balanced;
    exact when |d| <= 2^(8*n_limbs - 1) - 2^(8*(n_limbs-1) - 1))."""
    v = d
    outs = []
    for _ in range(n_limbs):
        dd = ((v + 128) & 255) - 128
        outs.append(dd.astype(jnp.int8))
        v = (v - dd) >> 8
    return outs


def n_digit_limbs(base_log: int) -> int:
    """int8 limbs needed for balanced digits in (-2^(bl-1), 2^(bl-1)]."""
    return (base_log + 7) // 8


# ---------------- host-side key preparation ----------------


def _limbs_i8_64(x: np.ndarray) -> np.ndarray:
    """uint64 -> 8 signed 8-bit limbs (last axis), exact mod 2^64."""
    v = x.astype(np.uint64).view(np.int64).copy()
    out = np.empty(x.shape + (8,), np.int8)
    for l in range(8):
        d = ((v + 128) & 255) - 128
        out[..., l] = d
        v = (v - d) >> 8
    assert np.all(np.abs(v) <= 1), "limb decomposition out of range"
    return out


def prepare_bsk64(params: Params, bsk: np.ndarray) -> np.ndarray:
    """bsk [n, (k+1)l, k+1, N] uint64 -> doubled int8 limbs
    [n, (k+1)l, k+1, 2N, 8].  Negation happens on the torus value BEFORE the
    limb split (see module docstring)."""
    g = bsk.astype(np.uint64)
    doubled = np.concatenate([g, (np.uint64(0) - g)], axis=-1)    # mod 2^64
    return _limbs_i8_64(doubled)


def prepare_ksk64(params: Params, ksk: np.ndarray) -> np.ndarray:
    """ksk [kN, L, n+1] uint64 -> [8, kN*L, n+1] int8 (contraction layout)."""
    kN, L, n1 = ksk.shape
    limbs = _limbs_i8_64(ksk.astype(np.uint64)).reshape(kN * L, n1, 8)
    return np.moveaxis(limbs, -1, 0).copy()


# ---------------- blind rotation ----------------


def negacyclic_rotate_batch64(lo, hi, r):
    """X^{r_b} * polys[b] on (lo, hi) pairs [B, C, N]; r [B] in [0, 2N)."""
    N = lo.shape[-1]
    for s in range(N.bit_length()):
        k = 1 << s
        if k < N:
            rlo = jnp.roll(lo, k, axis=-1)
            rhi = jnp.roll(hi, k, axis=-1)
            nlo, nhi = neg64(rlo[..., :k], rhi[..., :k])
            rlo = rlo.at[..., :k].set(nlo)
            rhi = rhi.at[..., :k].set(nhi)
        else:
            rlo, rhi = neg64(lo, hi)
        bit = ((r >> s) & 1).astype(bool)[:, None, None]
        lo = jnp.where(bit, rlo, lo)
        hi = jnp.where(bit, rhi, hi)
    return lo, hi


def _negacyclic_index(N: int) -> jnp.ndarray:
    i = jnp.arange(N)[:, None]
    j = jnp.arange(N)[None, :]
    return (j - i) & (2 * N - 1)


def external_product64(params: Params, d_lo, d_hi, quad8_i, acc_lo, acc_hi):
    """One CMUX external product on limb pairs.

    d_lo/d_hi  [B, k+1, N]   decomposition input (rot(acc) - acc)
    quad8_i    [(k+1)l, k+1, 2N, 8] int8 doubled GGSW limbs for step i
    acc        [B, k+1, N] pairs -> updated pairs
    """
    k1 = params.glwe_dimension + 1
    l = params.pbs_level
    N = params.polynomial_size
    B = d_lo.shape[0]
    nd = n_digit_limbs(params.pbs_base_log)

    digits = decompose64(d_lo, d_hi, params.pbs_base_log, l)      # [l, B, k1, N]
    d = jnp.transpose(digits, (1, 2, 0, 3)).reshape(B, k1 * l, N)
    dl = digit_limbs_i8(d, nd)                                    # nd x [B, rows, N]

    idx = _negacyclic_index(N)
    M = quad8_i[..., idx, :]                                      # [rows, k1, N, N, 8]

    out_lo = acc_lo
    out_hi = acc_hi
    for i in range(nd):
        for j in range(8):
            w = 8 * (i + j)
            if w >= 64:
                continue
            p = jnp.einsum("brn,rcnm->bcm", dl[i], M[..., j],
                           preferred_element_type=I32)            # exact, <=2^25
            plo, phi = i32_to_64_shifted(p, w)
            out_lo, out_hi = add64(out_lo, out_hi, plo, phi)
    return out_lo, out_hi


def blind_rotate64(params: Params, bsk8, luts_lo, luts_hi, lut_idx,
                   cts_ms) -> Tuple[jax.Array, jax.Array]:
    """[B, n+1] mod-switched cts -> [B, k+1, N] accumulator pairs."""
    k, N, n = (params.glwe_dimension, params.polynomial_size,
               params.lwe_dimension)
    B = cts_ms.shape[0]

    acc_lo = jnp.zeros((B, k + 1, N), I32).at[:, k, :].set(luts_lo[lut_idx])
    acc_hi = jnp.zeros((B, k + 1, N), I32).at[:, k, :].set(luts_hi[lut_idx])
    r0 = (2 * N - cts_ms[:, n]) & (2 * N - 1)
    acc_lo, acc_hi = negacyclic_rotate_batch64(acc_lo, acc_hi, r0)

    def step(carry, xs):
        acc_lo, acc_hi = carry
        a_i, quad8_i = xs
        rot_lo, rot_hi = negacyclic_rotate_batch64(acc_lo, acc_hi, a_i)
        nlo, nhi = neg64(acc_lo, acc_hi)
        d_lo, d_hi = add64(rot_lo, rot_hi, nlo, nhi)              # rot - acc
        acc_lo, acc_hi = external_product64(params, d_lo, d_hi, quad8_i,
                                            acc_lo, acc_hi)
        return (acc_lo, acc_hi), None

    (acc_lo, acc_hi), _ = jax.lax.scan(step, (acc_lo, acc_hi),
                                       (cts_ms[:, :n].T, bsk8))
    return acc_lo, acc_hi


# ---------------- sample extract + keyswitch ----------------


def sample_extract64(params: Params, acc_lo, acc_hi):
    """[B, k+1, N] pairs -> [B, kN+1] big-LWE pairs (coefficient 0)."""
    k, N = params.glwe_dimension, params.polynomial_size
    B = acc_lo.shape[0]

    def ext(lo, hi):
        mask_lo, mask_hi = lo[:, :k, :], hi[:, :k, :]
        f_lo, f_hi = mask_lo[:, :, :1], mask_hi[:, :, :1]
        r_lo, r_hi = neg64(mask_lo[:, :, :0:-1], mask_hi[:, :, :0:-1])
        e_lo = jnp.concatenate([f_lo, r_lo], axis=-1).reshape(B, k * N)
        e_hi = jnp.concatenate([f_hi, r_hi], axis=-1).reshape(B, k * N)
        return (jnp.concatenate([e_lo, lo[:, k, :1]], axis=-1),
                jnp.concatenate([e_hi, hi[:, k, :1]], axis=-1))

    # rest coefficients need 64-bit negation applied pairwise: do lo/hi
    # together (neg64 above couples them), so compute in one pass
    return ext(acc_lo, acc_hi)


def key_switch64(params: Params, ksk8, big_lo, big_hi):
    """[B, kN+1] pairs -> [B, n+1] pairs under the small LWE key.

    ksk8 [8, kN*L, n+1] int8; digits |.| <= Bks/2 = 4 -> int32 einsums exact.
    """
    kN, n = params.glwe_key_dim, params.lwe_dimension
    L = params.ks_level
    B = big_lo.shape[0]
    digits = decompose64(big_lo[:, :kN], big_hi[:, :kN],
                         params.ks_base_log, L)                   # [L, B, kN]
    D = jnp.transpose(digits, (1, 2, 0)).reshape(B, kN * L).astype(jnp.int8)

    out_lo = jnp.zeros((B, n + 1), I32).at[:, n].set(big_lo[:, kN])
    out_hi = jnp.zeros((B, n + 1), I32).at[:, n].set(big_hi[:, kN])
    for j in range(8):
        p = jnp.matmul(D, ksk8[j], preferred_element_type=I32)    # <= 2^23
        plo, phi = i32_to_64_shifted(p, 8 * j)
        nlo, nhi = neg64(plo, phi)
        out_lo, out_hi = add64(out_lo, out_hi, nlo, nhi)
    return out_lo, out_hi


# ---------------- full pipeline ----------------


@functools.partial(jax.jit, static_argnums=0)
def pbs_batch64(params: Params, bsk8, ksk8, luts_lo, luts_hi, lut_idx,
                cts_lo, cts_hi):
    """Full batched 64-bit PBS on int32 limb pairs: [B, n+1] -> [B, n+1]."""
    ms = mod_switch64(params, cts_lo, cts_hi)
    acc_lo, acc_hi = blind_rotate64(params, bsk8, luts_lo, luts_hi,
                                    lut_idx, ms)
    big_lo, big_hi = sample_extract64(params, acc_lo, acc_hi)
    return key_switch64(params, ksk8, big_lo, big_hi)
