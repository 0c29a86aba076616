"""Tensor parallelism INSIDE one bootstrap (SURVEY.md §2.3 "optional").

The reference has no analog (its only parallelism is intra-op threading).
Batch parallelism (mesh.py) is the main throughput lever; this module adds
the orthogonal axis for latency-critical small batches: the external
product's gadget-decomposition rows — (k+1)*l GGSW row polynomials per CMUX
step — are sharded across devices, each device contracts its row slice, and
a per-step ``psum`` between devices rebuilds the accumulator update.  This is the
matmul-formulation counterpart of sharding NTT butterfly stages with
all-to-alls: the collective moves [B, k+1, N] partial sums instead of
butterfly wavefronts.

The accumulator (and stage 1: rotation + decomposition) is replicated —
cheap elementwise work; the contraction (all the MACs) and the
bootstrap-key residency (the HBM pressure) divide by the mesh size.

Decrypted results are bit-exact vs the single-device path: the row split
re-associates exact integer sums only.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fhe_regex_tpu.ops.pbs import (
    _negacyclic_matrix,
    decompose,
    key_switch,
    mod_switch,
    negacyclic_rotate_batch,
    sample_extract,
)
from fhe_regex_tpu.params import Params

TP_AXIS = "tp"
I32 = jnp.int32


def make_tp_mesh(n_devices: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices[:n_devices]), (TP_AXIS,))


def _blind_rotate_rowsharded(params: Params, bsk_local, luts, lut_idx,
                             cts_ms, n_shards: int):
    """Blind rotation with this device's row slice of every GGSW.

    bsk_local [n, rows/D, k+1, N]; acc/digits replicated; each step ends in
    a psum over TP_AXIS that exchanges the [B, k+1, N] partial updates.
    """
    k, N, n, l = (params.glwe_dimension, params.polynomial_size,
                  params.lwe_dimension, params.pbs_level)
    B = cts_ms.shape[0]
    rows = (k + 1) * l
    local_rows = rows // n_shards
    r0 = jax.lax.axis_index(TP_AXIS) * local_rows

    lut = luts[lut_idx]
    acc0 = jnp.zeros((B, k + 1, N), dtype=I32).at[:, k, :].set(lut)
    acc = negacyclic_rotate_batch(acc0, (2 * N - cts_ms[:, n]) & (2 * N - 1))

    def step(acc, xs):
        a_i, ggsw_loc = xs                       # [B], [rows/D, k+1, N]
        rotated = negacyclic_rotate_batch(acc, a_i)
        diff = rotated - acc
        digits = decompose(diff, params.pbs_base_log, l)
        d = jnp.transpose(digits, (1, 2, 0, 3)).reshape(B, rows, N)
        d_loc = jax.lax.dynamic_slice_in_dim(d, r0, local_rows, axis=1)
        M = _negacyclic_matrix(ggsw_loc)         # [rows/D, k+1, N, N]
        part = jnp.einsum("brn,rcnm->bcm", d_loc, M,
                          preferred_element_type=I32)
        out = jax.lax.psum(part, TP_AXIS)        # exact int32 sum mod 2^32
        return acc + out, None

    acc, _ = jax.lax.scan(step, acc, (cts_ms[:, :n].T, bsk_local))
    return acc


def make_tp_pbs_fn(params: Params, server_key, mesh: Mesh):
    """(luts, lut_idx, cts) -> cts_out with the external product's row axis
    sharded over ``mesh`` (jnp formulation; 32-bit torus).

    Requires (k+1)*pbs_level % mesh size == 0 (6 rows at the primary set:
    meshes of 2, 3 or 6 devices).
    """
    rows = (params.glwe_dimension + 1) * params.pbs_level
    D = int(mesh.devices.size)
    if rows % D != 0:
        raise ValueError(f"rows={rows} not divisible by mesh size {D}")

    bsk = jnp.asarray(server_key.bsk.view(np.int32))
    ksk = jnp.asarray(server_key.ksk.view(np.int32))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, TP_AXIS), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(bsk_sh, ksk_r, luts, lut_idx, cts):
        ms = mod_switch(params, cts)
        acc = _blind_rotate_rowsharded(params, bsk_sh, luts, lut_idx, ms, D)
        big = sample_extract(params, acc)
        return key_switch(params, ksk_r, big)

    def fn(luts, lut_idx, cts):
        return run(bsk, ksk, luts, lut_idx, cts)

    return fn
