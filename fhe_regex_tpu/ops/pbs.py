"""Batched programmable bootstrapping in JAX (exact int32 torus arithmetic).

Instead of one bootstrap at a time inside each radix "smart" op (the
per-op PBS buried in tfhe-rs, SURVEY.md N9), the executor batches *all PBS
instances of a circuit level* into one launch — parallelism across PBS
instances (variants x positions x blocks), the main throughput lever
(SURVEY.md §2.3 "Batch parallelism within PBS").

Everything here operates on ``int32`` arrays whose bits are the uint32 torus
values; XLA defines integer overflow as two's-complement wraparound, so int32
add/sub/mul are exact arithmetic mod 2^32.

Shapes:
  cts      [B, n+1]               batch of LWE ciphertexts [a_0..a_{n-1}, b]
  bsk      [n, (k+1)*l, k+1, N]   bootstrap key (GGSW per secret bit)
  ksk      [kN, ks_level, n+1]    keyswitch key
  luts     [L, N]                 stacked test polynomials
  lut_idx  [B]                    which LUT each instance applies

Backends (one table, ``BACKENDS``; every formulation is plain jnp/lax that
XLA compiles for whatever device runs it):

  jnp     int32 scan/einsum over materialised negacyclic matrices — the
          exact specification path the tests compare against.
  int8    the same external product as ONE s8 x s8 -> s32 matrix product per
          CMUX step: key polys split host-side into 4 signed 8-bit limbs,
          recombined by shifts, exact mod 2^32 (blind_rotate_int8).
  jnp64   the 64-bit torus as int32 limb pairs (ops/pbs64.py).

``DEFAULT_BACKEND`` names the default per torus width, chosen by a
measurement on the card (see the comment there).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from fhe_regex_tpu.params import Params

I32 = jnp.int32
U32 = jnp.uint32


# ---------------- small exact helpers ----------------


def mod_switch(params: Params, cts: jax.Array) -> jax.Array:
    """[B, n+1] torus -> [B, n+1] values in [0, 2N).  Wraparound in the +half
    add contributes a multiple of 2N, so it vanishes mod 2N."""
    N = params.polynomial_size
    shift = params.torus_bits - (N.bit_length() - 1) - 1
    u = cts.astype(U32)
    half = jnp.uint32(1 << (shift - 1))
    return ((u + half) >> shift).astype(I32) & (2 * N - 1)


def decompose(v: jax.Array, base_log: int, level: int, torus_bits: int = 32):
    """Balanced signed gadget decomposition (jnp port of glwe.decompose_balanced).

    v: int32 torus values.  Returns [level, ...] int32 digits in [-B/2, B/2],
    digit j has weight q / B^(j+1) (most significant first).
    """
    B = 1 << base_log
    half = B // 2
    shift = torus_bits - base_log * level
    u = v.astype(U32)
    rounded = ((u + jnp.uint32(1 << (shift - 1))) >> shift).astype(I32)
    digits = []
    state = rounded
    for _ in range(level):
        d = state & (B - 1)
        d = jnp.where(d >= half, d - B, d)
        state = (state - d) >> base_log
        digits.append(d)
    return jnp.stack(digits[::-1])  # most significant first


def negacyclic_rotate_batch(polys: jax.Array, r: jax.Array) -> jax.Array:
    """X^{r_b} * polys[b] for each batch element.

    polys: [B, C, N] int32; r: [B] int32 in [0, 2N).  Returns [B, C, N].

    Implemented as log2(2N) per-instance-conditional static negacyclic
    rolls (select on each bit of r): static shifts fuse into elementwise
    loops, where a per-row data-dependent gather would not.
    """
    N = polys.shape[-1]
    x = polys
    for s in range(N.bit_length()):          # shifts 1, 2, ..., N
        k = 1 << s
        if k < N:
            rolled = jnp.roll(x, k, axis=-1)
            rolled = rolled.at[..., :k].multiply(-1)
        else:                                # shift by N == negate
            rolled = -x
        bit = ((r >> s) & 1).astype(bool)[:, None, None]
        x = jnp.where(bit, rolled, x)
    return x


def _negacyclic_index(N: int) -> jax.Array:
    """[N, N] index into a doubled poly (g, -g): M[i, j] = doubled[(j-i) mod 2N]."""
    i = jnp.arange(N)[:, None]
    j = jnp.arange(N)[None, :]
    return (j - i) & (2 * N - 1)


def _negacyclic_matrix(g: jax.Array) -> jax.Array:
    """[..., N] poly -> [..., N, N] negacyclic matrix M with (d @ M) = d (*) g.

    M[i, j] = g[j-i] for j >= i, -g[N+j-i] for j < i.
    """
    N = g.shape[-1]
    doubled = jnp.concatenate([g, -g], axis=-1)                  # [..., 2N]
    return doubled[..., _negacyclic_index(N)]


def _init_acc(params: Params, luts, lut_idx, cts_ms) -> jax.Array:
    """X^{-b~} * (0, ..., 0, lut): the blind rotation's starting accumulator."""
    k, N, n = params.glwe_dimension, params.polynomial_size, params.lwe_dimension
    B = cts_ms.shape[0]
    acc0 = jnp.zeros((B, k + 1, N), dtype=I32).at[:, k, :].set(luts[lut_idx])
    return negacyclic_rotate_batch(acc0, (2 * N - cts_ms[:, n]) & (2 * N - 1))


def _step_digits(params: Params, acc, a_i) -> jax.Array:
    """CMUX input: gadget digits of X^{a_i} acc - acc as [B, (k+1)l, N],
    rows ordered (component, level), most significant level first."""
    k, N, l = params.glwe_dimension, params.polynomial_size, params.pbs_level
    diff = negacyclic_rotate_batch(acc, a_i) - acc
    digits = decompose(diff, params.pbs_base_log, l)              # [l, B, k+1, N]
    return jnp.transpose(digits, (1, 2, 0, 3)).reshape(
        acc.shape[0], (k + 1) * l, N)


# ---------------- blind rotation (jnp reference path) ----------------


def blind_rotate(params: Params, bsk: jax.Array, luts: jax.Array,
                 lut_idx: jax.Array, cts_ms: jax.Array) -> jax.Array:
    """[B, n+1] mod-switched cts -> [B, k+1, N] accumulators."""
    n = params.lwe_dimension

    def step(acc, xs):
        a_i, ggsw_i = xs                                         # [B], [(k+1)l, k+1, N]
        d = _step_digits(params, acc, a_i)
        # external product via negacyclic matrices of the 12 GGSW polys:
        #   out[b, c, :] = sum_r  d[b, r, :] @ M(ggsw_i[r, c])
        M = _negacyclic_matrix(ggsw_i)                           # [(k+1)l, k+1, N, N]
        out = jnp.einsum("brn,rcnm->bcm", d, M,
                         preferred_element_type=I32)
        return acc + out, None

    acc = _init_acc(params, luts, lut_idx, cts_ms)
    acc, _ = jax.lax.scan(step, acc, (cts_ms[:, :n].T, bsk))
    return acc


def sample_extract(params: Params, accs: jax.Array) -> jax.Array:
    """[B, k+1, N] -> [B, kN+1] big-LWE ciphertexts (coefficient 0)."""
    k, N = params.glwe_dimension, params.polynomial_size
    mask = accs[:, :k, :]                                        # [B, k, N]
    first = mask[:, :, :1]
    rest = -mask[:, :, :0:-1]
    ext = jnp.concatenate([first, rest], axis=-1).reshape(accs.shape[0], k * N)
    body = accs[:, k, :1]
    return jnp.concatenate([ext, body], axis=-1)


def key_switch(params: Params, ksk: jax.Array, big: jax.Array) -> jax.Array:
    """[B, kN+1] -> [B, n+1] under the small LWE key."""
    kN, n = params.glwe_key_dim, params.lwe_dimension
    digits = decompose(big[:, :kN], params.ks_base_log, params.ks_level)  # [l, B, kN]
    acc = jnp.zeros((big.shape[0], n + 1), dtype=I32)
    acc = acc.at[:, n].set(big[:, kN])
    for j in range(params.ks_level):
        acc = acc - jnp.matmul(digits[j], ksk[:, j, :], preferred_element_type=I32)
    return acc


@functools.partial(jax.jit, static_argnums=0)
def pbs_batch(params: Params, bsk: jax.Array, ksk: jax.Array,
              luts: jax.Array, lut_idx: jax.Array, cts: jax.Array) -> jax.Array:
    """Full batched PBS: [B, n+1] -> [B, n+1] (jnp reference path)."""
    ms = mod_switch(params, cts)
    acc = blind_rotate(params, bsk, luts, lut_idx, ms)
    big = sample_extract(params, acc)
    return key_switch(params, ksk, big)


# ---------------- int8 limb-split route ----------------


def _limbs_int8(x: np.ndarray) -> np.ndarray:
    """int32 -> 4 signed 8-bit limbs in [-128, 127], last axis.

    Exact mod 2^32: balanced rounding can leave a +-1 carry of weight 2^32
    (e.g. 0x7FFFFFFF -> [-1,0,0,-128] + 1*2^32), which vanishes in the int32
    wraparound recombination — all downstream arithmetic is mod 2^32.
    """
    v = x.astype(np.int64)
    out = np.empty(x.shape + (4,), np.int8)
    for l in range(4):
        d = ((v + 128) & 255) - 128
        out[..., l] = d
        v = (v - d) >> 8
    assert np.all(np.abs(v) <= 1), "limb decomposition out of range"
    return out


def prepare_bsk_int8(params: Params, bsk: np.ndarray) -> np.ndarray:
    """bsk [n, (k+1)l, k+1, N] uint32 -> [n, (k+1)l, 2N, k+1, 4] int8.

    Each GGSW poly is doubled to (g, -g) — negation happens on the torus
    value BEFORE the limb split, so the device never negates an int8 limb
    (-128 would overflow) — and split into 4 signed 8-bit limbs.  The
    layout puts the doubled coefficient axis right after the row axis, so
    the per-step gather yields the product's contraction dims (row, i)
    leading and its output dims (j, component, limb) trailing.

    Exactness: digits |d| <= B/2 and limbs |x| <= 128, so every int32 dot
    sum is bounded by (k+1) l N (B/2) 128 — checked here against 2^31.
    """
    k, N, l = params.glwe_dimension, params.polynomial_size, params.pbs_level
    if (k + 1) * l * N * (params.pbs_base // 2) * 128 >= 1 << 31:
        raise ValueError(f"int8 route: dot sums can overflow int32 at "
                         f"{params.name}")
    if params.pbs_base_log > 7:
        raise ValueError("int8 route needs gadget digits that fit int8 "
                         f"(base_log <= 7), got {params.pbs_base_log}")
    g = bsk.view(np.int32).astype(np.int64)
    doubled = np.concatenate([g, -g], axis=-1)                  # [n, r, c, 2N]
    limbs = _limbs_int8((doubled & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    return np.ascontiguousarray(np.swapaxes(limbs, 2, 3))      # [n, r, 2N, c, 4]


def blind_rotate_int8(params: Params, bsk8: jax.Array, luts: jax.Array,
                      lut_idx: jax.Array, cts_ms: jax.Array) -> jax.Array:
    """[B, n+1] mod-switched cts -> [B, k+1, N] accumulators, with each CMUX
    external product as one int8 matrix product
    [B, (k+1)l N] x [(k+1)l N, N (k+1) 4] -> int32, limbs recombined by
    shifts (exact mod 2^32)."""
    k, N, n, l = (params.glwe_dimension, params.polynomial_size,
                  params.lwe_dimension, params.pbs_level)
    idx = _negacyclic_index(N)

    def step(acc, xs):
        a_i, q_i = xs                                  # [B], [rows, 2N, k+1, 4]
        d = _step_digits(params, acc, a_i).astype(jnp.int8)   # |d| <= 64
        M = q_i[:, idx]                                # [rows, N, N, k+1, 4]
        p = jnp.einsum("brn,rnmcl->bcml", d, M,
                       preferred_element_type=I32)     # [B, k+1, N, 4]
        out = p[..., 0]
        for j in range(1, 4):
            out = out + (p[..., j] << (8 * j))
        return acc + out, None

    acc = _init_acc(params, luts, lut_idx, cts_ms)
    acc, _ = jax.lax.scan(step, acc, (cts_ms[:, :n].T, bsk8))
    return acc


def prepare_ksk_limbs(params: Params, ksk: np.ndarray) -> np.ndarray:
    """ksk [kN, L, n+1] uint32 -> [4, kN*L, n+1] int8, contraction index
    (t, j) flattened row-major to match the keyswitch digit layout."""
    kN, L, n1 = ksk.shape
    return np.moveaxis(_limbs_int8(ksk.view(np.int32)).reshape(kN * L, n1, 4), -1, 0).copy()


def key_switch_limbs(params: Params, ksk_limbs, big):
    """Keyswitch as 4 exact limb matmuls.

    ksk_limbs [4, kN*L, n+1] bf16 holding signed 8-bit limb values; digits
    |.| <= Bks/2 = 4, so every product is an exact integer and the f32
    sums stay below kN*L*4*128 < 2^24: exact.
    """
    kN, n = params.glwe_key_dim, params.lwe_dimension
    L = params.ks_level
    digits = decompose(big[:, :kN], params.ks_base_log, L)      # [L, B, kN]
    D = jnp.transpose(digits, (1, 2, 0)).reshape(
        big.shape[0], kN * L).astype(jnp.bfloat16)
    acc = None
    for l in range(4):
        dot = jnp.dot(D, ksk_limbs[l], preferred_element_type=jnp.float32)
        part = dot.astype(I32) << (8 * l)
        acc = part if acc is None else acc + part
    out = -acc
    out = out.at[:, n].add(big[:, kN])
    return out


@functools.partial(jax.jit, static_argnums=0)
def pbs_batch_int8(params: Params, bsk8, ksk_limbs, luts, lut_idx, cts):
    """Full batched PBS on the int8 route: [B, n+1] -> [B, n+1]."""
    ms = mod_switch(params, cts)
    acc = blind_rotate_int8(params, bsk8, luts, lut_idx, ms)
    big = sample_extract(params, acc)
    return key_switch_limbs(params, ksk_limbs, big)


# ---------------- backend table ----------------


class DeviceServerKey:
    """Server-key material uploaded in the layout a PBS backend wants.

    ``arrays`` are the device arrays, in the order ``make_pbs_core``'s
    ``key`` argument takes them."""

    def __init__(self, params: Params, backend: str, arrays: tuple):
        self.params = params
        self.backend = backend
        self.arrays = tuple(arrays)


def _need_bits(params: Params, backend: str, bits: int) -> None:
    if params.torus_bits != bits:
        raise ValueError(f"backend {backend!r} needs a {bits}-bit "
                         f"parameter set, got {params.name}")


def _prep_jnp(params, sk):
    _need_bits(params, "jnp", 32)
    return (jnp.asarray(sk.bsk.view(np.int32)),
            jnp.asarray(sk.ksk.view(np.int32)))


def _core_jnp(params):
    def core(key, luts, lut_idx, cts):
        return pbs_batch(params, key[0], key[1], luts, lut_idx, cts)
    return core


def _prep_int8(params, sk):
    _need_bits(params, "int8", 32)
    return (jnp.asarray(prepare_bsk_int8(params, sk.bsk)),
            jnp.asarray(prepare_ksk_limbs(params, sk.ksk)).astype(jnp.bfloat16))


def _core_int8(params):
    def core(key, luts, lut_idx, cts):
        return pbs_batch_int8(params, key[0], key[1], luts, lut_idx, cts)
    return core


def _prep_jnp64(params, sk):
    from fhe_regex_tpu.ops import pbs64
    _need_bits(params, "jnp64", 64)
    return (jnp.asarray(pbs64.prepare_bsk64(params, sk.bsk)),
            jnp.asarray(pbs64.prepare_ksk64(params, sk.ksk)))


def _core_jnp64(params):
    from fhe_regex_tpu.ops import pbs64

    def core(key, luts, lut_idx, cts):
        # luts [L, N, 2] / cts [B, n+1, 2] int32 limb pairs
        out_lo, out_hi = pbs64.pbs_batch64(
            params, key[0], key[1], luts[..., 0], luts[..., 1],
            lut_idx, cts[..., 0], cts[..., 1])
        return jnp.stack([out_lo, out_hi], axis=-1)
    return core


#: backend -> (prepare(params, server_key) -> device arrays,
#:             core(params) -> (key, luts, lut_idx, cts) -> cts_out)
BACKENDS = {
    "jnp": (_prep_jnp, _core_jnp),
    "int8": (_prep_int8, _core_int8),
    "jnp64": (_prep_jnp64, _core_jnp64),
}

# Default PBS formulation per torus width, chosen by the route comparison
# in chip_smoke.py on one H100 (700 W limit; TPU_MESSAGE_2_CARRY_2, one
# launch, block_until_ready), PBS/s at B = 64 / 256 / 1024:
#   int8  218 / 788 / 1482   exact (== jnp == golden model)
#   jnp    22 /  23 /   23   exact
#   an f32 FFT route (cuFFT) reached 1096 / 1854 / 1651 but decrypted 1-2%
#   of bootstraps wrong (rare rounding tails past +-0.5), so it was removed.
# 64 bits: jnp64 is the only route (172 / 451 PBS/s at B = 64 / 256).
DEFAULT_BACKEND = {32: "int8", 64: "jnp64"}


def resolve_backend(backend: Optional[str],
                    params: Optional[Params] = None) -> str:
    if backend is None:
        return DEFAULT_BACKEND[params.torus_bits if params is not None else 32]
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {sorted(BACKENDS)}")
    return backend


def prepare_server_key(params: Params, server_key,
                       backend: Optional[str] = None) -> DeviceServerKey:
    """Upload the server key in ``backend``'s layout (default: the width's
    measured default)."""
    backend = resolve_backend(backend, params)
    prep, _ = BACKENDS[backend]
    return DeviceServerKey(params, backend, prep(params, server_key))


def key_arrays(dev_key: DeviceServerKey) -> tuple:
    """The device arrays a PBS backend needs, as an explicit tuple.

    Callers that re-jit around the PBS (the level executor) MUST pass these
    as jit ARGUMENTS: a closed-over key becomes an embedded HLO constant —
    a multi-hundred-MB literal in every compiled module, and one executable
    per key instead of one per shape."""
    return dev_key.arrays


def make_pbs_core(dev_key: DeviceServerKey):
    """(key_args, luts, lut_idx, cts) -> cts_out with keys as arguments
    (see key_arrays).  Pair with ``key_arrays(dev_key)``."""
    _, core = BACKENDS[dev_key.backend]
    return core(dev_key.params)


def make_pbs_fn(dev_key: DeviceServerKey):
    """Callable (luts, lut_idx, cts) -> cts_out for the prepared key."""
    return functools.partial(make_pbs_core(dev_key), key_arrays(dev_key))


def server_key_device_arrays(server_key) -> tuple:
    """Upload server key material as int32 device arrays."""
    bsk = jnp.asarray(server_key.bsk.view(np.int32))
    ksk = jnp.asarray(server_key.ksk.view(np.int32))
    return bsk, ksk
