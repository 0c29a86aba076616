"""Collective homomorphic OR-tree reduction.

Replaces the reference's sequential ct_or left-fold over branch results
(engine.rs:22-35) when running sharded: each device OR-folds its local branch
bits (log-depth inside the batched circuit), then log2(D) rounds of
``ppermute`` + one homomorphic OR (a single bootstrap per device per round)
combine partial results across the mesh.

The decrypted result is identical to the reference's fold — OR is
associative and every op re-encrypts through a bootstrap — only the op
*order* differs (SURVEY.md §7; use the executor's default reference-order
fold when counter parity matters).
"""

from __future__ import annotations

from functools import partial

import jax

from jax.sharding import Mesh, PartitionSpec as P

from fhe_regex_tpu.ops.pbs import DeviceServerKey, make_pbs_fn
from fhe_regex_tpu.parallel.mesh import BATCH_AXIS


def or_tree_across_devices(dev_key: DeviceServerKey, mesh: Mesh):
    """Build fn(luts, or_lut_idx, bits) -> replicated OR of per-device bits.

    ``bits``: [D, n+1] int32, one partial-OR ciphertext per device (sharded on
    the leading axis).  Returns [D, n+1] with every row the full OR.
    """
    pbs = make_pbs_fn(dev_key)
    n_dev = mesh.devices.size

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(BATCH_AXIS)),
        out_specs=P(BATCH_AXIS),
        check_vma=False,
    )
    def reduce_fn(luts, or_lut_idx, bits):
        # bits: [1, n+1] per device
        steps = max(1, (n_dev - 1).bit_length())
        acc = bits
        for r in range(steps):
            shift = 1 << r
            perm = [(i, (i + shift) % n_dev) for i in range(n_dev)]
            recv = jax.lax.ppermute(acc, BATCH_AXIS, perm)
            # homomorphic OR: LUT(acc + 2*recv)
            acc = pbs(luts, or_lut_idx, acc + 2 * recv)
        return acc

    return reduce_fn
