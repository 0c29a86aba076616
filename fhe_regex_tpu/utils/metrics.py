"""Cost model + run counters.

The reference's only observability is the ct_ops / cache_hits pair logged at
the end of a run (execution.rs:56-62, engine.rs:36-40).  We keep those
(emitted by has_match) and add bootstrap counts, level counts, and an
analytic operation model of the blind rotation.  No device peak is
assumed here: rates are measured on the card (bench.py, chip_smoke.py).
"""

from __future__ import annotations

import dataclasses

from fhe_regex_tpu.params import Params


@dataclasses.dataclass
class PbsCost:
    macs_per_pbs: float        # int8 multiply-accumulates per bootstrap
    key_bytes_per_pbs: float   # bootstrap-key traffic per bootstrap


def pbs_cost_model(params: Params, limbs: int = 4) -> PbsCost:
    """Work of one programmable bootstrap in the int8 matrix formulation.

    Per CMUX step: (k+1)*level digit polys each convolved into (k+1) output
    polys; each negacyclic polymul is an N x N matmul done `limbs` times for
    exactness.
    """
    n = params.lwe_dimension
    k1 = params.glwe_dimension + 1
    rows = k1 * params.pbs_level
    N = params.polynomial_size
    macs = float(n) * rows * k1 * limbs * N * N
    # bootstrap key bytes streamed once per *batch*, amortized over batch=1
    key_bytes = float(n) * rows * k1 * N * 4
    return PbsCost(macs_per_pbs=macs, key_bytes_per_pbs=key_bytes)


# ---------------- multi-card communication model -------
#
# Predicts the collective traffic and scaling efficiency of each
# parallelism strategy (parallel/mesh.py, parallel/collective.py,
# parallel/tensor.py) from first principles, so a measured scaling
# efficiency (benchmarks/scaling.py, chip_smoke.py --multi) can falsify it.
# The per-card bootstrap rate and tensor parallelism's replicated share of
# a launch are inputs: both are measurements on the card, not constants.
#
# Link anchors: NVLink 4 on an H100 SXM moves 900 GB/s per card to the
# other cards of its host, 450 GB/s each way (NVIDIA H100 data sheet);
# between hosts one NDR InfiniBand port moves 400 Gb/s = 50 GB/s each way
# (NVIDIA ConnectX-7 data sheet).  Latency floor per collective hop:
# ~5 us (NVLink) / ~10 us (InfiniBand), assumed.
NVLINK_BW = 450e9
NVLINK_LAT = 5e-6
IB_BW = 50e9
IB_LAT = 10e-6


def comm_model(params: Params, n_devices: int, batch_per_device: int,
               *, pbs_rate_per_chip: float, tp_glue_fraction: float,
               link_bw: float = NVLINK_BW, link_lat: float = NVLINK_LAT,
               net_bw: float = IB_BW, net_lat: float = IB_LAT,
               hosts: int = 1) -> dict:
    """Bytes-and-time model for the three parallelism strategies.

    Returns per-strategy dicts with the bytes each collective moves, the
    rounds it takes, and the predicted scaling efficiency at the given
    per-card bootstrap rate.  ``tp_glue_fraction`` is the share of a
    launch that tensor parallelism cannot divide (rotate/decompose,
    keyswitch and glue are replicated on every card).

    * batch (parallel/mesh.py): levels shard the PBS batch; NO steady-state
      collective (each chip bootstraps its slice; key material replicated).
      The only cross-chip traffic is the final OR-tree.
    * or-tree (parallel/collective.py): ceil(log2(D)) ppermute rounds, one
      LWE ciphertext [n+1] per device per round (x2 limb words at 64 bit),
      plus ONE bootstrap per round per device.
    * tensor (parallel/tensor.py): the (k+1)*l GGSW rows of each CMUX step
      shard over D; every step psums [B, (k+1), N] int32 partials — a ring
      all-reduce moves 2(D-1)/D of that per chip per step, n steps per PBS.
    """
    n = params.lwe_dimension
    k1 = params.glwe_dimension + 1
    N = params.polynomial_size
    word = 4 if params.torus_bits == 32 else 8
    D = n_devices
    B = batch_per_device

    lwe_bytes = (n + 1) * word
    rounds = (D - 1).bit_length()          # ceil(log2 D); 0 at D == 1
    bw = net_bw if hosts > 1 else link_bw
    lat = net_lat if hosts > 1 else link_lat

    # --- OR-tree: log rounds, one ct + one bootstrap each ---
    or_bytes = rounds * lwe_bytes
    or_time = rounds * (lwe_bytes / bw + lat + 1.0 / pbs_rate_per_chip)

    # --- batch parallelism over a whole run_many-style launch ---
    # compute time for the local slice vs the OR-tree epilogue
    t_compute = B / pbs_rate_per_chip
    batch_eff = t_compute / (t_compute + or_time)

    # --- tensor parallelism inside one bootstrap ---
    psum_bytes_step = B * k1 * N * word          # the partial accumulator
    ring = 2.0 * (D - 1) / D if D > 1 else 0.0
    tp_bytes = n * psum_bytes_step * ring        # per chip per batched PBS
    t_tp_comm = n * (psum_bytes_step * ring / bw + 2 * lat)
    # external-product work divides by D; the glue share is replicated
    t_one = B / pbs_rate_per_chip
    g = tp_glue_fraction
    t_tp = t_one * (1.0 - g) / D + t_one * g + t_tp_comm
    tp_speedup = t_one / t_tp if t_tp > 0 else float("inf")

    return {
        "devices": D, "hosts": hosts, "word_bytes": word,
        "or_tree": {"rounds": rounds, "bytes_per_device": or_bytes,
                    "seconds": or_time},
        "batch": {"steady_state_bytes": 0, "efficiency": batch_eff},
        "tensor": {"bytes_per_chip_per_batched_pbs": tp_bytes,
                   "psum_bytes_per_step": psum_bytes_step,
                   "comm_seconds": t_tp_comm,
                   "speedup_at_D": tp_speedup},
    }
