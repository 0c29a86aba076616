"""Pin the multi-card communication model (utils/metrics.py::comm_model).

The per-card bootstrap rate and the tensor-parallel glue share are model
inputs; the values below are example inputs, not measurements."""

from fhe_regex_tpu.params import TPU64_MESSAGE_2_CARRY_2, TPU_MESSAGE_2_CARRY_2
from fhe_regex_tpu.utils.metrics import IB_BW, NVLINK_BW, comm_model

EXAMPLE = dict(pbs_rate_per_chip=1000.0, tp_glue_fraction=0.2)


def test_batch_parallel_meets_the_baseline_target():
    """BASELINE's >=80% scaling target must hold in the model with wide
    margin — batch parallelism has no steady-state collective."""
    for D in (2, 4, 8, 16):
        m = comm_model(TPU_MESSAGE_2_CARRY_2, D, 1792, **EXAMPLE)
        assert m["batch"]["steady_state_bytes"] == 0
        assert m["batch"]["efficiency"] > 0.95, D


def test_or_tree_is_pbs_dominated_and_log_depth():
    m4 = comm_model(TPU_MESSAGE_2_CARRY_2, 4, 1792, **EXAMPLE)
    m8 = comm_model(TPU_MESSAGE_2_CARRY_2, 8, 1792, **EXAMPLE)
    assert m4["or_tree"]["rounds"] == 2 and m8["or_tree"]["rounds"] == 3
    # each round's cost is ~1 bootstrap, not bandwidth
    assert m8["or_tree"]["seconds"] < 0.01
    # 64-bit doubles the ciphertext words
    m64 = comm_model(TPU64_MESSAGE_2_CARRY_2, 8, 1024, **EXAMPLE)
    assert m64["or_tree"]["bytes_per_device"] > m8["or_tree"]["bytes_per_device"]


def test_tensor_parallel_predictions():
    """TP: a win inside one NVLink host, bounded by the replicated glue;
    the slower inter-host network erodes it (keep TP inside a host)."""
    one = comm_model(TPU_MESSAGE_2_CARRY_2, 8, 1792, hosts=1, **EXAMPLE)
    two = comm_model(TPU_MESSAGE_2_CARRY_2, 8, 1792, hosts=2, **EXAMPLE)
    assert 1.0 < one["tensor"]["speedup_at_D"] < 1.0 / EXAMPLE["tp_glue_fraction"]
    assert two["tensor"]["speedup_at_D"] < one["tensor"]["speedup_at_D"]
    # the psum volume is the real number to check on hardware: ~44 GB/card
    assert 30e9 < one["tensor"]["bytes_per_chip_per_batched_pbs"] < 60e9
    assert NVLINK_BW == 450e9 and IB_BW < NVLINK_BW
