"""Benchmark: bootstraps/sec/chip on the primary parameter set.

Prints one JSON line per metric on stdout:

  {"metric": "pbs_per_sec_per_chip", "value": N, "unit": "bootstraps/s",
   "vs_baseline": N / 100, "backend": ..., "batch": B, "params": ...,
   "platform": ..., "device_kind": ..., "device_count": ...,
   "card": "<nvidia-smi name, power.limit>"}

then the same record for ``pbs_per_sec_per_chip_ref64``: the reference's
exact 64-bit bundle (REF_MESSAGE_2_CARRY_2_64) on its width's default
backend (BENCH_REF64=0 skips it).

Baseline: the reference's crypto stack (tfhe-rs 0.2 on CPU) runs a
PARAM_MESSAGE_2_CARRY_2 bootstrap in O(10 ms) single-thread (BASELINE.md —
the repo publishes no numbers; 100 bootstraps/s is the CPU baseline row).
Correctness is asserted in-run: every timed batch is decrypted and checked.

One process: it measures on the first accelerator JAX finds and fails when
there is none.  ``--rehearse`` runs the same code on the CPU at the test
parameter set (for the test suite); its numbers are not device numbers.
Every window ends in ``block_until_ready``.

Env: BENCH_PARAMS, BENCH_BACKEND, BENCH_BATCH, BENCH_ITERS,
BENCH_REF64=0, BENCH_PROFILE=<dir> (JAX trace of the timed window).
Keys for the full parameter sets are generated once and cached in .cache/.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CACHE = Path(__file__).parent / ".cache"


def _get_keys(params):
    from fhe_regex_tpu.crypto.keys import gen_keys
    from fhe_regex_tpu.crypto.csprng import Csprng

    CACHE.mkdir(exist_ok=True)
    path = CACHE / f"bench_keys_{params.name}.npz"
    if path.exists():
        z = np.load(path)
        from fhe_regex_tpu.crypto.keys import ClientKey, ServerKey
        ck = ClientKey(params=params, lwe_key=z["lwe_key"],
                       glwe_key=z["glwe_key"], rng=Csprng(0xBE7C4))
        sk = ServerKey(params=params, bsk=z["bsk"], ksk=z["ksk"])
        return ck, sk
    t0 = time.time()
    ck, sk = gen_keys(params, seed=0xBE7C4)
    print(f"# keygen {time.time() - t0:.1f}s", file=sys.stderr)
    np.savez(path, lwe_key=ck.lwe_key, glwe_key=ck.glwe_key,
             bsk=sk.bsk, ksk=sk.ksk)
    return ck, sk


def card() -> "str | None":
    """The card's name and power limit as nvidia-smi reports them, or None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


def device_record() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()), "card": card()}


def _record(metric: str, rate: float, **extra) -> dict:
    return dict({"metric": metric, "value": rate, "unit": "bootstraps/s",
                 "vs_baseline": rate / 100.0}, **extra)


def measure(params, ck, sk, backend: str, B: int, iters: int) -> float:
    """One (backend, batch) point: compile, time, decrypt-gate.  Returns
    pbs/s; raises on a correctness failure."""
    import jax
    import jax.numpy as jnp

    from fhe_regex_tpu.crypto import lwe
    from fhe_regex_tpu.crypto.golden import make_lut_poly
    from fhe_regex_tpu.ops.pbs import make_pbs_fn, prepare_server_key
    from fhe_regex_tpu.regex.executor import _limbs_to_np, _np_to_limbs

    pbs = make_pbs_fn(prepare_server_key(params, sk, backend))
    msgs = np.arange(B) % 16
    cts = np.stack([lwe.encrypt_lwe(params, ck.lwe_key, int(m), ck.rng)
                    for m in msgs])
    luts = jnp.asarray(_np_to_limbs(
        np.stack([make_lut_poly(params, lambda x: (x * 3 + 1) % 16)]),
        params.torus_bits))
    lut_idx = jnp.zeros(B, jnp.int32)
    ctsj = jnp.asarray(_np_to_limbs(cts, params.torus_bits))

    t0 = time.perf_counter()
    pbs(luts, lut_idx, ctsj).block_until_ready()
    print(f"# [{params.name} {backend} B={B}] compile+first run "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)

    import contextlib
    prof_dir = os.environ.get("BENCH_PROFILE")
    prof = (jax.profiler.trace(prof_dir) if prof_dir
            else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = pbs(luts, lut_idx, ctsj)
        out.block_until_ready()
        dt = time.perf_counter() - t0
    rate = iters * B / dt

    o = _limbs_to_np(np.asarray(out), params.torus_bits)
    got = np.array([lwe.decrypt_lwe(params, ck.lwe_key, o[i])
                    for i in range(B)])
    n_bad = int((got != (msgs * 3 + 1) % 16).sum())
    if n_bad:
        raise AssertionError(f"{params.name} {backend} B={B}: "
                             f"{n_bad}/{B} bootstraps decrypt wrong")
    print(f"# [{params.name} {backend} B={B}] {rate:.1f} pbs/s",
          file=sys.stderr, flush=True)
    return rate


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="bench.py")
    ap.add_argument("--rehearse", action="store_true",
                    help="allow a CPU run at the test parameter sets")
    args = ap.parse_args(argv)

    from fhe_regex_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fhe_regex_tpu.ops.pbs import resolve_backend
    from fhe_regex_tpu.params import get_params

    dev = device_record()
    if dev["platform"] == "cpu" and not args.rehearse:
        print("bench.py: no accelerator found (use --rehearse for a CPU "
              "rehearsal)", file=sys.stderr)
        return 1
    rehearse = dev["platform"] == "cpu"
    iters = int(os.environ.get("BENCH_ITERS", "2" if rehearse else "5"))
    B = int(os.environ.get("BENCH_BATCH", "8" if rehearse else "1024"))
    params = get_params(os.environ.get(
        "BENCH_PARAMS", "TEST_PARAMS" if rehearse else "TPU_MESSAGE_2_CARRY_2"))
    stages = [("pbs_per_sec_per_chip", params,
               os.environ.get("BENCH_BACKEND"))]
    if os.environ.get("BENCH_REF64", "1") not in ("0", "off"):
        stages.append(("pbs_per_sec_per_chip_ref64", get_params(
            "TEST_PARAMS_64" if rehearse else "REF_MESSAGE_2_CARRY_2_64"),
            None))
    for metric, p, backend in stages:
        backend = resolve_backend(backend, p)
        ck, sk = _get_keys(p)
        rate = measure(p, ck, sk, backend, B, iters)
        print(json.dumps(_record(metric, rate, backend=backend, batch=B,
                                 params=p.name, iters=iters, **dev)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
