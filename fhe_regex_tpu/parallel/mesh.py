"""Device mesh + sharded PBS execution.

The reference is strictly single-threaded at the application layer
(SURVEY.md §2.3: Rc-based closures, sequential OR-fold) — its only
parallelism is rayon inside one op.  The replacement here is SPMD over
a ``jax.sharding.Mesh``: the PBS **batch axis** (all bootstrap instances of a
circuit level = variants x positions x blocks) is sharded across devices
with ``shard_map``; server-key material is replicated; XLA compiles the
collective movement onto the device interconnect (NVLink within a host).
The mesh is one flat batch axis: every card reaches every other at the
same rate, so it follows the algorithm, not a topology.

Multi-host: the same program under ``jax.distributed.initialize`` — the mesh
just spans more devices; nothing else changes.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fhe_regex_tpu.ops.pbs import DeviceServerKey, make_pbs_fn

BATCH_AXIS = "batch"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            # a silently smaller mesh changes collective semantics (an
            # OR-tree over 1 device is the identity) — fail loudly instead
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} JAX device(s) are visible (set "
                f"XLA_FLAGS=--xla_force_host_platform_device_count=N for "
                f"virtual CPU devices)")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (BATCH_AXIS,))


def make_sharded_pbs_fn(dev_key: DeviceServerKey, mesh: Mesh):
    """(luts, lut_idx, cts) -> cts_out with the batch axis sharded over the
    mesh.  Key material rides in closure (replicated per device by shard_map's
    closure capture); batch width must be a multiple of mesh size.
    """
    pbs = make_pbs_fn(dev_key)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(BATCH_AXIS), P(BATCH_AXIS)),
        out_specs=P(BATCH_AXIS),
        check_vma=False,
    )
    def sharded(luts, lut_idx, cts):
        return pbs(luts, lut_idx, cts)

    return sharded


def make_sharded_mv_core(dev_key: DeviceServerKey, mesh: Mesh,
                         positions=None):
    """Sharded multi-value level core (ops/mv.py) for Executor._run_level_mv.

    (key_args, vlut, weights, leader, rot_cts) -> outputs, with BOTH batch
    axes sharded: each device rotates its slice of the deduped rotation
    batch, the accumulators are all-gathered (R x (k+1) x N int32
    <= a few MB per level), and each device derives its slice of the op
    outputs from the replicated accumulators.  Rotation and op widths must
    be multiples of the mesh size (compile with min_bucket >= mesh size).
    """
    from fhe_regex_tpu.ops.mv import make_mv_finish_core, make_mv_rotate_core
    from fhe_regex_tpu.ops.pbs import key_arrays

    rotate = make_mv_rotate_core(dev_key)
    finish = make_mv_finish_core(dev_key)
    n_key = len(key_arrays(dev_key))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=((P(),) * n_key, P(), P(BATCH_AXIS), P(BATCH_AXIS),
                  P(BATCH_AXIS)),
        out_specs=P(BATCH_AXIS),
        check_vma=False,
    )
    def sharded(key, vlut, weights, leader, rot_cts):
        accs_local = rotate(key, vlut, rot_cts)          # [R/D, ...]
        # leaders index the FULL rotation batch: gather it (tiled concat
        # restores global row order) — a few MB per level
        accs = jax.lax.all_gather(accs_local, BATCH_AXIS, tiled=True)
        return finish(key, accs, weights, leader, positions)

    return sharded


def make_sharded_mv_rotate_core(dev_key: DeviceServerKey, mesh: Mesh):
    """Sharded phase A of a packed multivalue level (Executor.run_many):
    (key, vlut, rot_cts) -> accumulators, rotation batch sharded."""
    from fhe_regex_tpu.ops.mv import make_mv_rotate_core
    from fhe_regex_tpu.ops.pbs import key_arrays

    rotate = make_mv_rotate_core(dev_key)
    n_key = len(key_arrays(dev_key))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=((P(),) * n_key, P(), P(BATCH_AXIS)),
        out_specs=P(BATCH_AXIS),
        check_vma=False,
    )
    def sharded(key, vlut, rot_cts):
        return rotate(key, vlut, rot_cts)

    return sharded


def make_sharded_mv_finish_core(dev_key: DeviceServerKey, mesh: Mesh,
                                positions=None):
    """Sharded phase B: (key, accs, weights, leader) -> outputs; the op
    batch is sharded, the accumulators replicated (leaders may reference
    any rotation row)."""
    from fhe_regex_tpu.ops.mv import make_mv_finish_core
    from fhe_regex_tpu.ops.pbs import key_arrays

    finish = make_mv_finish_core(dev_key)
    n_key = len(key_arrays(dev_key))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=((P(),) * n_key, P(), P(BATCH_AXIS), P(BATCH_AXIS)),
        out_specs=P(BATCH_AXIS),
        check_vma=False,
    )
    def sharded(key, accs, weights, leader):
        return finish(key, accs, weights, leader, positions)

    return sharded


def make_sharded_pbs_core(dev_key: DeviceServerKey, mesh: Mesh):
    """Sharded PBS with the server key as explicit REPLICATED arguments.

    (key_args, luts, lut_idx, cts) -> cts_out.  Callers that re-jit around
    the PBS (the level executor) must use this form — closed-over keys embed
    as HLO literals and overflow remote-compile request limits (pbs.py
    key_arrays)."""
    from fhe_regex_tpu.ops.pbs import key_arrays, make_pbs_core

    core = make_pbs_core(dev_key)
    n_key = len(key_arrays(dev_key))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=((P(),) * n_key, P(), P(BATCH_AXIS), P(BATCH_AXIS)),
        out_specs=P(BATCH_AXIS),
        check_vma=False,
    )
    def sharded(key, luts, lut_idx, cts):
        return core(key, luts, lut_idx, cts)

    return sharded
