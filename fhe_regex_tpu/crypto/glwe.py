"""GLWE/GGSW encryption and server-key material generation (NumPy, client-side).

This is the replacement for the key generation inside
``tfhe::integer::gen_keys_radix`` (reference src/regex/ciphertext.rs:42-45;
SURVEY.md N2): LWE secret key, GLWE secret key, GGSW bootstrap key (one GGSW
per LWE secret bit) and the LWE keyswitch key (big kN key -> small n key).

Conventions (32-bit torus, uint32 with wraparound = mod 2^32):
  - GLWE ct of message poly M: ``(A_1..A_k, B)`` with
    ``B = sum_j A_j (*) S_j + M + E``  ((*) = negacyclic product mod X^N+1).
  - GGSW of bit m: rows indexed (comp i' in 0..k, level j in 0..l-1); row =
    GLWE(0) + m * g_j * unit(i'), where g_j = q / B^(j+1).
  - Balanced signed gadget decomposition with closest-representable rounding.
"""

from __future__ import annotations

import numpy as np

from fhe_regex_tpu.params import Params

U32 = np.uint32
I64 = np.int64


def negacyclic_polymul(a: np.ndarray, b: np.ndarray,
                       torus_bits: int = 32) -> np.ndarray:
    """Exact negacyclic product mod (X^N + 1), coefficients mod 2^torus_bits.

    Reference semantics of concrete-fft's negacyclic f64 FFT polymul
    (SURVEY.md N10) — here computed exactly over the integers.  Requires at
    least one operand small (gadget digits / binary key), which holds
    everywhere this is used; the 64-bit path limb-splits the full operand
    into 16-bit limbs so int64 convolutions stay exact.
    """
    n = a.shape[-1]
    if torus_bits == 32:
        # center to int32 range so int64 products cannot overflow (result is
        # the same mod 2^32)
        ac = np.ascontiguousarray(a, dtype=U32).view(np.int32).astype(I64)
        bc = np.ascontiguousarray(b, dtype=U32).view(np.int32).astype(I64)
        full = np.convolve(ac, bc)
        res = full[:n].copy()
        res[: n - 1] -= full[n:]
        return res.astype(np.uint64).astype(U32)
    U64 = np.uint64
    au = np.ascontiguousarray(a, dtype=U64)
    bu = np.ascontiguousarray(b, dtype=U64)
    ac = au.view(np.int64)
    bc = bu.view(np.int64)
    # put the small operand first
    if np.abs(bc).max(initial=0) < np.abs(ac).max(initial=0):
        ac, bc, au, bu = bc, ac, bu, au
    assert np.abs(ac).max(initial=0) < (1 << 24), "no small operand for 64-bit polymul"
    acc = np.zeros(n, U64)
    for j in range(4):
        limb = ((bu >> U64(16 * j)) & U64(0xFFFF)).astype(I64)
        full = np.convolve(ac, limb)
        res = full[:n].copy()
        res[: n - 1] -= full[n:]
        with np.errstate(over="ignore"):
            acc = acc + (res.astype(U64) << U64(16 * j))
    return acc


def decompose_balanced(v: np.ndarray, base_log: int, level: int, torus_bits: int = 32):
    """Balanced signed gadget decomposition.

    Returns int32 digits ``d[level, ...]`` with d[j] the digit of weight
    q / B^(j+1) (most significant first), each in [-B/2, B/2], such that
    ``sum_j d[j] * q/B^(j+1)`` is within q/(2 B^level) of v.
    """
    B = 1 << base_log
    half = B // 2
    shift = torus_bits - base_log * level
    # closest-representable rounding to a multiple of q / B^level
    v64 = v.astype(np.uint64)
    rounded = (v64 + (np.uint64(1) << np.uint64(shift - 1))) >> np.uint64(shift)
    digits = np.empty((level,) + v.shape, dtype=np.int64)
    state = rounded.astype(np.int64)
    for j in range(level - 1, -1, -1):  # least significant digit first
        d = state & (B - 1)
        d = np.where(d >= half, d - B, d)
        state = (state - d) >> base_log
        digits[j] = d
    return digits.astype(np.int32)


def recompose(digits: np.ndarray, base_log: int, level: int, torus_bits: int = 32):
    acc = np.zeros(digits.shape[1:], dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(level):
            g = np.uint64(1) << np.uint64(torus_bits - base_log * (j + 1))
            acc += digits[j].astype(np.int64).astype(np.uint64) * g
    return acc.astype(U32 if torus_bits == 32 else np.uint64)


def encrypt_glwe(params: Params, S: np.ndarray, M: np.ndarray, rng) -> np.ndarray:
    """GLWE ciphertext [(k+1), N] of message polynomial M [N]."""
    k, N, tb = params.glwe_dimension, params.polynomial_size, params.torus_bits
    dt = np.uint32 if tb == 32 else np.uint64
    ct = np.empty((k + 1, N), dtype=dt)
    body = np.zeros(N, dtype=dt)
    with np.errstate(over="ignore"):
        for j in range(k):
            a = rng.uniform_torus(N, tb)
            ct[j] = a
            body = (body + negacyclic_polymul(a, S[j], tb)).astype(dt)
        e = rng.gaussian_torus(N, params.glwe_noise_std, tb)
        ct[k] = (body + M.astype(dt) + e).astype(dt)
    return ct


def decrypt_glwe(params: Params, S: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """Phase polynomial (message + noise) of a GLWE ciphertext."""
    k, tb = params.glwe_dimension, params.torus_bits
    dt = np.uint32 if tb == 32 else np.uint64
    phase = ct[k].copy()
    with np.errstate(over="ignore"):
        for j in range(k):
            phase = (phase - negacyclic_polymul(ct[j], S[j], tb)).astype(dt)
    return phase


def encrypt_ggsw_bit(params: Params, S: np.ndarray, m: int, rng) -> np.ndarray:
    """GGSW of a bit m: [(k+1)*level, (k+1), N]."""
    k, N, l = params.glwe_dimension, params.polynomial_size, params.pbs_level
    tb = params.torus_bits
    dt = np.uint32 if tb == 32 else np.uint64
    rows = np.empty(((k + 1) * l, k + 1, N), dtype=dt)
    zero = np.zeros(N, dtype=dt)
    r = 0
    mask = (1 << tb) - 1
    for comp in range(k + 1):
        for j in range(l):
            row = encrypt_glwe(params, S, zero, rng)
            g = dt((1 << (tb - params.pbs_base_log * (j + 1))) & mask)
            with np.errstate(over="ignore"):
                row[comp, 0] = (row[comp, 0] + dt(m) * g).astype(dt)
            rows[r] = row
            r += 1
    return rows


def external_product(params: Params, ggsw: np.ndarray, glwe_ct: np.ndarray) -> np.ndarray:
    """GGSW (x) GLWE -> GLWE encrypting (bit * message)."""
    k, N, l = params.glwe_dimension, params.polynomial_size, params.pbs_level
    tb = params.torus_bits
    dt = np.uint32 if tb == 32 else np.uint64
    out = np.zeros((k + 1, N), dtype=dt)
    r = 0
    with np.errstate(over="ignore"):
        for comp in range(k + 1):
            digits = decompose_balanced(glwe_ct[comp], params.pbs_base_log, l, tb)
            for j in range(l):
                d = digits[j]
                for c in range(k + 1):
                    out[c] = (out[c] + negacyclic_polymul(d, ggsw[r, c], tb)).astype(dt)
                r += 1
    return out


def gen_bootstrap_key(params: Params, lwe_key: np.ndarray, S: np.ndarray, rng):
    """[n, (k+1)*level, (k+1), N] — GGSW of each LWE secret bit (SURVEY N2)."""
    return np.stack(
        [encrypt_ggsw_bit(params, S, int(lwe_key[i]), rng) for i in range(params.lwe_dimension)]
    )


def gen_keyswitch_key(params: Params, big_key: np.ndarray, lwe_key: np.ndarray, rng):
    """[kN, ks_level, n+1] — LWE_s(big_s[t] * q/Bks^(j+1)) for each t, j."""
    from fhe_regex_tpu.crypto.lwe import encrypt_lwe  # local to avoid cycle

    kN = params.glwe_key_dim
    n = params.lwe_dimension
    tb = params.torus_bits
    dt = np.uint32 if tb == 32 else np.uint64
    mask = (1 << tb) - 1
    ksk = np.empty((kN, params.ks_level, n + 1), dtype=dt)
    with np.errstate(over="ignore"):
        for t in range(kN):
            for j in range(params.ks_level):
                ct = encrypt_lwe(params, lwe_key, 0, rng)
                g = dt((1 << (tb - params.ks_base_log * (j + 1))) & mask)
                ct[n] = (ct[n] + dt(int(big_key[t])) * g).astype(dt)
                ksk[t, j] = ct
    return ksk


def flatten_glwe_key(S: np.ndarray) -> np.ndarray:
    """GLWE key [k, N] -> big LWE key [kN] (sample-extraction order)."""
    return S.reshape(-1)
