"""Run the reference conformance vectors UNDER THE REFERENCE'S OWN KEYS.

Loads `/root/reference/test_data/client_key` (the tfhe-rs 0.2 bincode
``RadixClientKey`` fixture, engine.rs:248-254), reconstructs our ClientKey
around the reference's actual LWE/GLWE secrets (crypto/refkey.py), derives
the server key exactly like ``ServerKey::new(&client_key)`` (engine.rs:252),
and runs the 25 reference vectors (engine.rs:256-280) plus the quirk vectors
end-to-end at the reference's exact 64-bit parameter point
(``REF_MESSAGE_2_CARRY_2_64``) with REAL client encryption.

This is the strongest cross-implementation parity evidence obtainable
without a Rust toolchain: content encrypted under the reference's secret
key, bootstrapped through the device PBS, decrypted with the reference's
secret key, compared against the reference's own expected outputs.

Usage:  python benchmarks/refkey_vectors.py [--quick N] [--backend B]
Writes one JSON line per vector + a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    from fhe_regex_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", type=int, default=0,
                    help="run only the first N vectors")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--quirks", action="store_true",
                    help="also run the quirk vectors")
    args = ap.parse_args()

    import numpy as np
    from fhe_regex_tpu import decrypt, encrypt_str, has_match
    from fhe_regex_tpu.crypto.keys import ServerKey, server_key_from_client
    from fhe_regex_tpu.crypto.refkey import client_key_from_fixture

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    from test_engine import QUIRK_VECTORS, REFERENCE_VECTORS

    t0 = time.time()
    ck, ref = client_key_from_fixture(seed=2026)
    params = ck.params
    cache = Path(__file__).resolve().parents[1] / ".cache" / "refkey_server.npz"
    cache.parent.mkdir(exist_ok=True)
    if cache.exists():
        z = np.load(cache)
        sk = ServerKey(params=params, bsk=z["bsk"], ksk=z["ksk"])
    else:
        sk = server_key_from_client(ck)
        np.savez(cache, bsk=sk.bsk, ksk=sk.ksk)
    print(f"# keys ready ({params.name}, reference fixture secrets) "
          f"in {time.time()-t0:.1f}s", file=sys.stderr)

    vectors = list(REFERENCE_VECTORS)
    if args.quirks:
        vectors += list(QUIRK_VECTORS)
    if args.quick:
        vectors = vectors[: args.quick]

    n_pass = 0
    for i, (content, pattern, exp) in enumerate(vectors):
        t1 = time.time()
        ct = encrypt_str(ck, content)
        res = has_match(sk, ct, pattern, backend=args.backend)
        got = decrypt(ck, res)
        ok = int(got) == int(exp)
        n_pass += ok
        print(json.dumps({
            "vector": i, "content": content, "pattern": pattern,
            "expected": exp, "got": int(got), "ok": ok,
            "seconds": round(time.time() - t1, 2),
        }), flush=True)
        if not ok:
            print(f"# MISMATCH on vector {i}", file=sys.stderr)

    summary = {"metric": "refkey_vectors_pass", "value": n_pass,
               "total": len(vectors), "params": params.name,
               "wall_s": round(time.time() - t0, 1)}
    print(json.dumps(summary), flush=True)
    return 0 if n_pass == len(vectors) else 1


if __name__ == "__main__":
    raise SystemExit(main())
