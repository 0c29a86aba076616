"""Serving throughput: one pattern vs many encrypted contents
(has_match_many / Executor.run_many).

Levels amortize across the content batch, so per-content latency drops
roughly by the batch factor until level batches saturate the kernel width.
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
    import numpy as np
    from fhe_regex_tpu import (decrypt, encrypt_str, has_match_many,
                               trivial_encrypt_str)
    from fhe_regex_tpu.params import TPU_MESSAGE_2_CARRY_2
    from bench import _get_keys

    params = TPU_MESSAGE_2_CARRY_2
    C = int(os.environ.get("SERVE_BATCH", "32"))
    pattern = os.environ.get("SERVE_PATTERN", "/abc/")
    ck, sk = _get_keys(params)

    rng = np.random.default_rng(0)
    contents = []
    for i in range(C):
        base = list("xxxxxabcxxxxxxxx")
        if i % 2:  # half the batch should not match
            base[6] = "q"
        contents.append("".join(base))
    real = os.environ.get("BENCH_ENC", "trivial") == "real"
    enc = (lambda c: encrypt_str(ck, c)) if real \
        else (lambda c: trivial_encrypt_str(params, c))
    cts = np.stack([enc(c) for c in contents])

    t0 = time.time()
    res = has_match_many(sk, cts, pattern)
    warm = time.time() - t0
    got = [decrypt(ck, res[i]) for i in range(C)]
    want = [1 if i % 2 == 0 else 0 for i in range(C)]
    assert got == want, got

    t0 = time.time()
    res = has_match_many(sk, cts, pattern)
    dt = time.time() - t0
    assert [decrypt(ck, res[i]) for i in range(C)] == want

    print(json.dumps({
        "metric": "serving_throughput",
        "encryption": "real" if real else "trivial",
        "pattern": pattern, "batch": C,
        "first_s": round(warm, 2),
        "steady_s": round(dt, 2),
        "per_content_s": round(dt / C, 3),
        "contents_per_s": round(C / dt, 2),
    }))


if __name__ == "__main__":
    main()
