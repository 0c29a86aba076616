#!/usr/bin/env python3
"""Bring-up check: the encrypted-match path on one NVIDIA GPU, end to end.

Run from the root of a checkout:

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --multi    # four cards: the mesh phase only

Phases (one process, production parameter sets, data from --seed):

  native   build native/ (make -C native) and report the circuit engine
  routes   time the 32-bit PBS routes (the jnp spec path, the int8 default)
           at launch widths 64/256/1024 and jnp64 at the 64-bit set; every
           route bit-exact against the others and the NumPy golden model
           (also at REF_MESSAGE_2_CARRY_2_64); memory_analysis of a launch
  match32  has_match with real client encryption on the five BASELINE.json
           configurations plus the north star, each checked by decryption
           against the plaintext dialect oracle
  match64  the same for two configurations at TPU64_MESSAGE_2_CARRY_2
  serve    MatchService + its HTTP server on a thread: /match, /match_many
           and a 256-char /match_long from an in-process client, decrypted
           and checked
  policy   (only when named in --phases) the executor's launch policies on
           and off: fused levels, minimum bucket, wide run_many shape
  multi    (--multi, four cards) batch-sharded mesh and OR-tree collective
           against the same work on one card, ciphertexts bit-equal

Prints the card's name and power limit, the default backend per torus
width and every phase result; the last line is one JSON object.  Exits
non-zero, printing no result, when a phase fails, when JAX finds no GPU, or
when it runs outside a checkout.  Details go to chiprun_out/ beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"
ROUTES32 = ("jnp", "int8")
PHASES = ("native", "routes", "match32", "match64", "serve")
MATCH64_CONFIGS = ("exact_literal", "contains_anchors")


class PhaseFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require_checkout() -> None:
    if not (REPO / "fhe_regex_tpu" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: no fhe_regex_tpu/ beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(REPO))


def require_gpus(count: int) -> list:
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py: JAX found no GPU (platform "
                         f"{devs[0].platform!r})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke.py: needs {count} GPUs, JAX sees "
                         f"{len(devs)}")
    return devs


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise SystemExit("chip_smoke.py: nvidia-smi gave no card name")
    return out.stdout.strip()


# ---------------- keys and data ----------------


class Keys:
    """Client/server keys per parameter set, made once from the seed."""

    def __init__(self, seed: int):
        self.seed = seed
        self._keys: dict = {}

    def __call__(self, params):
        if params.name not in self._keys:
            from fhe_regex_tpu.crypto.keys import gen_keys
            t0 = time.perf_counter()
            self._keys[params.name] = gen_keys(params, seed=self.seed)
            log(f"  keygen {params.name}: {time.perf_counter() - t0:.1f}s")
        return self._keys[params.name]


def _lut_fn(x):
    return (3 * x + 1) % 16


def _golden(params, bsk, ksk, cts, lut):
    from fhe_regex_tpu.crypto.golden import pbs
    return np.stack([pbs(params, bsk, ksk, ct, lut) for ct in cts])


class GoldenPool:
    """NumPy golden-model bootstraps in worker processes (host only: they
    never touch the card), started early so they overlap device work;
    with workers=0 they run in this process (small test sizes)."""

    def __init__(self, workers: int = 0):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        self.pool = (ProcessPoolExecutor(workers,
                                         mp_context=mp.get_context("spawn"))
                     if workers else None)

    def submit(self, params, sk, cts, lut):
        if self.pool is None:
            from concurrent.futures import Future
            fut = Future()
            fut.set_result(_golden(params, sk.bsk, sk.ksk, cts, lut))
            return [fut]
        return [self.pool.submit(_golden, params, sk.bsk, sk.ksk, ct[None],
                                 lut) for ct in cts]

    @staticmethod
    def result(futs) -> np.ndarray:
        return np.concatenate([f.result() for f in futs])

    def close(self):
        if self.pool is not None:
            self.pool.shutdown(cancel_futures=True)


# ---------------- phases ----------------


def phase_native() -> dict:
    """Build the C++ circuit compiler and CSPRNG from the committed sources."""
    out = subprocess.run(["make", "-C", str(REPO / "native")],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise PhaseFailure(f"make -C native failed:\n{out.stderr[-2000:]}")
    from fhe_regex_tpu.regex.native import default_engine
    engine = default_engine()
    if engine != "native":
        raise PhaseFailure(f"native/ built but the engine is {engine!r}")
    return {"engine": engine}


def _time_launches(fn, args, iters: int):
    """(seconds of the compile+first call, seconds per launch, output)."""
    t0 = time.perf_counter()
    fn(*args).block_until_ready()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    out.block_until_ready()
    return first, (time.perf_counter() - t0) / iters, out


def phase_routes(keys: Keys, p32, p64, pref, widths, iters: int = 3,
                 golden_n: int = 2, slow_s: float = 20.0,
                 pool: "GoldenPool | None" = None) -> dict:
    """Time the 32-bit routes and jnp64 at the given launch widths; every
    output bit-exact against the other route and the golden model."""
    import jax
    import jax.numpy as jnp

    from fhe_regex_tpu.crypto import lwe
    from fhe_regex_tpu.crypto.golden import make_lut_poly
    from fhe_regex_tpu.ops.pbs import (key_arrays, make_pbs_core,
                                       make_pbs_fn, prepare_server_key,
                                       resolve_backend)
    from fhe_regex_tpu.regex.executor import _limbs_to_np, _np_to_limbs

    widths = sorted(widths)
    report = {"routes": [], "errors": []}
    pool = pool or GoldenPool()

    def data(params, B):
        ck, sk = keys(params)
        cts = np.stack([lwe.encrypt_lwe(params, ck.lwe_key, int(m), ck.rng)
                        for m in np.arange(B) % 16])
        return ck, sk, cts, make_lut_poly(params, _lut_fn)

    # golden bootstraps first: they run on the host while the card works
    pending = {}
    for params, B in ((p32, widths[0]), (p64, widths[0]), (pref, 8)):
        if params is not None:
            ck, sk, cts, lut = data(params, B)
            pending[params.name] = (ck, sk, cts, lut, pool.submit(
                params, sk, cts[:golden_n], lut))

    def run_routes(params, routes, bwidths):
        ck, sk, cts, lut, futs = pending[params.name]
        if max(bwidths) > len(cts):
            cts = np.concatenate([cts, data(params, max(bwidths) - len(cts))[2]])
        msgs = np.concatenate([np.arange(bwidths[0]) % 16,
                               np.arange(len(cts) - bwidths[0]) % 16])
        tb = params.torus_bits
        luts = jnp.asarray(_np_to_limbs(lut[None], tb))
        first_out = {}
        golden = GoldenPool.result(futs)
        for name in routes:
            fn = make_pbs_fn(prepare_server_key(params, sk, name))
            per_b = None
            for B in bwidths:
                row = {"params": params.name, "route": name, "B": B}
                if per_b is not None and per_b * B > slow_s:
                    row["skipped"] = (f"predicted {per_b * B:.0f}s per "
                                      f"launch > {slow_s:.0f}s")
                    report["routes"].append(row)
                    log(f"  {name:6s} B={B:5d}  skipped: {row['skipped']}")
                    continue
                ctsj = jnp.asarray(_np_to_limbs(cts[:B], tb))
                idx = jnp.zeros(B, jnp.int32)
                first, per, out = _time_launches(
                    fn, (luts, idx, ctsj), iters if per_b is None
                    or per_b * B < 2.0 else 1)
                per_b = per / B
                o = _limbs_to_np(np.asarray(out), tb)
                got = np.array([lwe.decrypt_lwe(params, ck.lwe_key, o[i])
                                for i in range(B)])
                if B in first_out:
                    row["bitexact_vs_" + first_out[B][0]] = bool(
                        np.array_equal(o, first_out[B][1]))
                else:
                    first_out[B] = (name, o)
                if B == bwidths[0]:
                    row["bitexact_vs_golden"] = bool(
                        np.array_equal(o[:len(golden)], golden))
                row.update(first_s=first, launch_s=per, pbs_per_s=B / per,
                           wrong=int((got != _lut_fn(msgs[:B])).sum()))
                report["routes"].append(row)
                log(f"  {name:6s} B={B:5d}  first {first:7.2f}s  launch "
                    f"{per:8.4f}s  {B / per:9.1f} pbs/s  wrong {row['wrong']}"
                    + "".join(f"  {k}={v}" for k, v in row.items()
                              if k.startswith("bitexact")))
                if row["wrong"] or any(v is False for k, v in row.items()
                                       if k.startswith("bitexact")):
                    report["errors"].append(row)

    log(f"  routes at {p32.name} (n={p32.lwe_dimension}, "
        f"N={p32.polynomial_size}), widths {widths}")
    run_routes(p32, ROUTES32, widths)
    if p64 is not None:
        log(f"  jnp64 at {p64.name}")
        run_routes(p64, ("jnp64",), widths[:2])
    if pref is not None:
        log(f"  jnp64 at {pref.name} (golden check)")
        run_routes(pref, ("jnp64",), [8])

    # one level launch's compiled memory footprint on the default backend
    _, sk = keys(p32)
    dk = prepare_server_key(p32, sk)
    B = min(256, widths[-1])
    n1 = p32.lwe_dimension + 1
    compiled = jax.jit(make_pbs_core(dk)).lower(
        key_arrays(dk), jnp.zeros((128, p32.polynomial_size), jnp.int32),
        jnp.zeros(B, jnp.int32), jnp.zeros((B, n1), jnp.int32)).compile()
    mem = compiled.memory_analysis()
    if mem is not None:
        report["memory_analysis"] = {
            k: int(getattr(mem, k)) for k in
            ("argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, k)}
        log(f"  memory_analysis {resolve_backend(None, p32)} B={B}: "
            f"{report['memory_analysis']}")
    report["key_bytes"] = int(sum(a.nbytes for a in key_arrays(dk)))
    if report["errors"]:
        raise PhaseFailure(f"route checks failed: {report['errors']}")
    return report


def _configs(names=None):
    from fhe_regex_tpu.models.patterns import (BASELINE_CONFIGS,
                                               BASELINE_CONTENTS, NORTH_STAR)
    cfgs = BASELINE_CONFIGS + [NORTH_STAR]
    if names is not None:
        cfgs = [c for c in cfgs if c["name"] in names]
    return [(c["name"], c["pattern"], BASELINE_CONTENTS[c["name"]])
            for c in cfgs]


def phase_match(keys: Keys, params, configs) -> dict:
    """has_match with real client encryption; every result decrypts to the
    plaintext oracle's answer."""
    from fhe_regex_tpu import decrypt, encrypt_str, has_match
    from fhe_regex_tpu.regex.oracle import oracle_match

    ck, sk = keys(params)
    rows, bad = [], []
    for name, pattern, content in configs:
        want = oracle_match(content, pattern)
        ct = encrypt_str(ck, content)
        t0 = time.perf_counter()
        got = decrypt(ck, has_match(sk, ct, pattern))
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = decrypt(ck, has_match(sk, ct, pattern))
        warm = time.perf_counter() - t0
        row = {"config": name, "pattern": pattern, "len": len(content),
               "want": want, "got": got, "cold_s": cold, "warm_s": warm}
        rows.append(row)
        log(f"  {params.name} {name:26s} len={len(content):3d} "
            f"want {want} got {got}/{again}  cold {cold:7.2f}s "
            f"warm {warm:7.3f}s")
        if got != want or again != want:
            bad.append(row)
    if bad:
        raise PhaseFailure(f"wrong results: {bad}")
    return {"configs": rows}


def _post(url: str, body: dict) -> dict:
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        return json.loads(r.read())


def phase_serve(keys: Keys, params, long_len: int = 256,
                long_window: "int | None" = None) -> dict:
    """The serving daemon in this process, answered over HTTP."""
    from fhe_regex_tpu import decrypt, encrypt_str
    from fhe_regex_tpu.regex.oracle import oracle_match
    from fhe_regex_tpu.serve import (MatchService, decode_array,
                                     encode_array, make_server)

    ck, sk = keys(params)
    service = MatchService(sk)
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    rows, bad = [], []

    def check(endpoint, pattern, contents, body):
        t0 = time.perf_counter()
        rep = _post(base + endpoint, body)
        dt = time.perf_counter() - t0
        if "error" in rep:
            raise PhaseFailure(f"{endpoint}: {rep['error']}")
        res = decode_array(rep["ct"])
        res = res[None] if len(contents) == 1 else res
        got = [decrypt(ck, r) for r in res]
        want = [oracle_match(c, pattern) for c in contents]
        row = {"endpoint": endpoint, "pattern": pattern, "n": len(contents),
               "len": len(contents[0]), "want": want, "got": got,
               "seconds": dt}
        rows.append(row)
        log(f"  {endpoint:12s} {pattern:24s} x{len(contents)} "
            f"len={len(contents[0]):3d} want {want} got {got}  {dt:7.2f}s")
        if got != want:
            bad.append(row)

    try:
        for pattern, content in (("/abc/", "xxxxxabcxxxxxxxx"),
                                 ("/^[a-d][^xyz]$/i", "Dx")):
            check("/match", pattern, [content],
                  {"pattern": pattern,
                   "ct": encode_array(encrypt_str(ck, content))})
        many = ["xxabcxxx", "xxaqcxxx", "abcabcab", "xxxxxxxx"]
        check("/match_many", "/abc/", many,
              {"pattern": "/abc/", "ct": encode_array(
                  np.stack([encrypt_str(ck, c) for c in many]))})
        rng = np.random.default_rng(keys.seed)
        doc = "".join(rng.choice(list("xyzw"), long_len))
        doc = doc[:long_len // 2] + "abc" + doc[long_len // 2 + 3:]
        body = {"pattern": "/abc/", "ct": encode_array(encrypt_str(ck, doc))}
        if long_window is not None:
            body["window"] = long_window
        check("/match_long", "/abc/", [doc], body)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if bad:
        raise PhaseFailure(f"wrong served results: {bad}")
    return {"requests": rows}


def phase_policy(keys: Keys, params) -> dict:
    """Each executor launch policy on and off, on one configuration."""
    import fhe_regex_tpu.regex.executor as ex
    from fhe_regex_tpu import decrypt, encrypt_str, has_match, has_match_many

    ck, sk = keys(params)
    name, pattern, content = _configs(["contains_anchors"])[0]
    ct = encrypt_str(ck, content)
    rows = []

    def run(label, fn):
        t0 = time.perf_counter()
        fn()                                   # compile + first run
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = fn()
        rows.append({"setting": label, "first_s": first,
                     "warm_s": time.perf_counter() - t0})
        log(f"  {label:40s} first {first:7.2f}s  warm "
            f"{rows[-1]['warm_s']:.3f}s")
        return res

    saved = (ex.FUSE_LEVELS, ex.MIN_BUCKET)
    try:
        for fuse in (True, False):
            for mb in (8, ex.SMALL_LEVEL_BATCH):
                ex.FUSE_LEVELS, ex.MIN_BUCKET = fuse, mb
                res = run(f"{name} fuse={fuse} min_bucket={mb}",
                          lambda: has_match(sk, ct, pattern))
                assert decrypt(ck, res) == 1
    finally:
        ex.FUSE_LEVELS, ex.MIN_BUCKET = saved
    cts = np.stack([encrypt_str(ck, content)] * 32)
    for wide in (True, False):
        res = run(f"{name} run_many C=32 wide={wide}",
                  lambda: has_match_many(sk, cts, pattern, wide_batch=wide))
        assert all(decrypt(ck, r) == 1 for r in res)
    return {"policy": rows}


def phase_multi(keys: Keys, params, n_dev: int = 4, B: int = 1024) -> dict:
    """Batch-sharded mesh path and OR-tree collective over n_dev cards,
    against the same work on one card (exact integer route: bit-equal)."""
    import jax
    import jax.numpy as jnp

    from fhe_regex_tpu import decrypt, encrypt_str, has_match
    from fhe_regex_tpu.crypto import lwe
    from fhe_regex_tpu.crypto.golden import make_lut_poly
    from fhe_regex_tpu.ops.luts import LUT_OR2, lut_fn
    from fhe_regex_tpu.ops.pbs import make_pbs_fn, prepare_server_key
    from fhe_regex_tpu.parallel.collective import or_tree_across_devices
    from fhe_regex_tpu.parallel.mesh import make_mesh, make_sharded_pbs_fn
    from fhe_regex_tpu.regex.oracle import oracle_match

    ck, sk = keys(params)
    mesh = make_mesh(n_dev)
    exact = "int8" if params.torus_bits == 32 else "jnp64"
    dk = prepare_server_key(params, sk, exact)
    rows = {}

    # one level launch, sharded vs one card
    msgs = np.arange(B) % 16
    cts = np.stack([lwe.encrypt_lwe(params, ck.lwe_key, int(m), ck.rng)
                    for m in msgs])
    luts = jnp.asarray(make_lut_poly(params, _lut_fn)[None].view(np.int32))
    idx = jnp.zeros(B, jnp.int32)
    ctsj = jnp.asarray(cts.view(np.int32))
    one_first, one_s, one = _time_launches(make_pbs_fn(dk),
                                           (luts, idx, ctsj), 1)
    shd_first, shd_s, shd = _time_launches(
        jax.jit(make_sharded_pbs_fn(dk, mesh)), (luts, idx, ctsj), 1)
    equal = bool(np.array_equal(np.asarray(one), np.asarray(shd)))
    rows["level"] = {"B": B, "one_card_s": one_s, "mesh_s": shd_s,
                     "one_card_first_s": one_first, "mesh_first_s": shd_first,
                     "bit_equal": equal}
    log(f"  level B={B}: one card {one_s:.3f}s, {n_dev} cards {shd_s:.3f}s, "
        f"bit-equal {equal}")

    # has_match through the public mesh= entry point
    name, pattern, content = _configs(["contains_anchors"])[0]
    ct = encrypt_str(ck, content)
    r_one = has_match(sk, ct, pattern, backend=exact)
    t0 = time.perf_counter()
    r_mesh = has_match(sk, ct, pattern, backend=exact, mesh=mesh)
    dt = time.perf_counter() - t0
    want = oracle_match(content, pattern)
    m_equal = bool(np.array_equal(r_one, r_mesh))
    rows["has_match"] = {"config": name, "want": want,
                         "got": decrypt(ck, r_mesh), "bit_equal": m_equal,
                         "mesh_s": dt}
    log(f"  has_match {name} mesh={n_dev}: want {want} got "
        f"{rows['has_match']['got']} bit-equal {m_equal}")

    # OR-tree collective: one encrypted 1 among n_dev partial results
    luts2 = jnp.asarray(np.stack([make_lut_poly(params, lambda x: x),
                                  make_lut_poly(params, lut_fn(LUT_OR2))])
                        .view(np.int32))
    bits = np.stack([lwe.encrypt_lwe(params, ck.lwe_key,
                                     int(i == n_dev - 1), ck.rng)
                     for i in range(n_dev)])
    from jax.sharding import NamedSharding, PartitionSpec
    from fhe_regex_tpu.parallel.mesh import BATCH_AXIS
    bits_d = jax.device_put(jnp.asarray(bits.view(np.int32)),
                            NamedSharding(mesh, PartitionSpec(BATCH_AXIS)))
    red = or_tree_across_devices(dk, mesh)(luts2, jnp.ones((), jnp.int32),
                                           bits_d)
    r = np.asarray(red).view(np.uint32)
    ors = [lwe.decrypt_lwe(params, ck.lwe_key, r[i]) for i in range(n_dev)]
    rows["or_tree"] = {"ors": ors}
    log(f"  OR-tree over {n_dev} cards: {ors} (want all 1)")
    if not (equal and m_equal and rows["has_match"]["got"] == want
            and all(v == 1 for v in ors)):
        raise PhaseFailure(f"mesh results differ: {rows}")
    return rows


# ---------------- main ----------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the mesh phase and nothing else")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: %(default)s)")
    ap.add_argument("--widths", default="64,256,1024",
                    help="route-comparison launch widths")
    args = ap.parse_args(argv)

    require_checkout()
    from fhe_regex_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n_dev = 4 if args.multi else 1
    devs = require_gpus(n_dev)
    log(card_line())

    from fhe_regex_tpu.ops.pbs import resolve_backend
    from fhe_regex_tpu.params import get_params

    p32 = get_params("TPU_MESSAGE_2_CARRY_2")
    p64 = get_params("TPU64_MESSAGE_2_CARRY_2")
    pref = get_params("REF_MESSAGE_2_CARRY_2_64")
    log(f"backend: 32-bit {resolve_backend(None, p32)}, "
        f"64-bit {resolve_backend(None, p64)}")
    keys = Keys(args.seed)
    phases = ["multi"] if args.multi else args.phases.split(",")
    widths = [int(w) for w in args.widths.split(",")]
    results, failed = {}, []
    pool = GoldenPool(6) if "routes" in phases else None
    try:
        for ph in phases:
            log(f"phase {ph}:")
            t0 = time.perf_counter()
            try:
                if ph == "native":
                    res = phase_native()
                elif ph == "routes":
                    res = phase_routes(keys, p32, p64, pref, widths,
                                       pool=pool)
                elif ph == "match32":
                    res = phase_match(keys, p32, _configs())
                elif ph == "match64":
                    res = phase_match(keys, p64, _configs(MATCH64_CONFIGS))
                elif ph == "serve":
                    res = phase_serve(keys, p32)
                elif ph == "policy":
                    res = phase_policy(keys, p32)
                elif ph == "multi":
                    res = phase_multi(keys, p32, n_dev)
                else:
                    raise PhaseFailure(f"unknown phase {ph!r}")
                status = "ok"
            except Exception as e:                  # noqa: BLE001
                import traceback
                traceback.print_exc()
                res, status = {"error": f"{type(e).__name__}: {e}"}, "FAILED"
                failed.append(ph)
            res["seconds"] = time.perf_counter() - t0
            results[ph] = res
            log(f"phase {ph}: {status} ({res['seconds']:.1f}s)")
    finally:
        if pool is not None:
            pool.close()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"chip_smoke_{'_'.join(phases)}.json").write_text(
        json.dumps(results, indent=1, default=str))
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
