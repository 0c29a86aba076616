"""Scaling-efficiency benchmark: bootstraps/s on 1 device vs the full mesh.

On a multi-chip slice this measures the BASELINE.json scaling target
(>=80% efficiency at 2 hosts: run under jax.distributed on every host).
On a single chip it degenerates to a sanity check.  CPU virtual meshes
validate correctness of the sharded path, not performance.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    from fhe_regex_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fhe_regex_tpu.params import TPU_MESSAGE_2_CARRY_2
    from fhe_regex_tpu.crypto import lwe
    from fhe_regex_tpu.crypto.golden import make_lut_poly
    from fhe_regex_tpu.ops.pbs import make_pbs_fn, prepare_server_key
    from fhe_regex_tpu.parallel.mesh import make_mesh, make_sharded_pbs_fn
    from bench import _get_keys

    params = TPU_MESSAGE_2_CARRY_2
    per_dev = int(os.environ.get("SCALE_BATCH_PER_DEV", "256"))
    iters = int(os.environ.get("SCALE_ITERS", "2"))
    n_dev = len(jax.devices())

    ck, sk = _get_keys(params)
    dev_key = prepare_server_key(params, sk)
    lut = make_lut_poly(params, lambda x: x)
    luts = jnp.asarray(lut[None].view(np.int32))

    def measure(fn, B):
        cts = np.stack([lwe.encrypt_lwe(params, ck.lwe_key, i % 16, ck.rng)
                        for i in range(B)])
        ctsj = jnp.asarray(cts.view(np.int32))
        idx = jnp.zeros(B, jnp.int32)
        np.asarray(fn(luts, idx, ctsj))          # warmup/compile
        t0 = time.time()
        out = None
        for _ in range(iters):
            out = fn(luts, idx, ctsj)
        np.asarray(out)
        return iters * B / (time.time() - t0)

    single = measure(make_pbs_fn(dev_key), per_dev)
    result = {"metric": "scaling_efficiency", "devices": n_dev,
              "single_dev_pbs_per_s": round(single, 2)}
    if n_dev > 1:
        mesh = make_mesh()
        full = measure(make_sharded_pbs_fn(dev_key, mesh), per_dev * n_dev)
        result.update({
            "mesh_pbs_per_s": round(full, 2),
            "efficiency": round(full / (single * n_dev), 3),
        })
    print(json.dumps(result))


if __name__ == "__main__":
    main()
