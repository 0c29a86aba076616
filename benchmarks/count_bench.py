"""Encrypted match counting latency (count_matches) at a chosen set.

VERDICT r4 next #10: the 64-bit serving evidence covered mv serving only —
this probe records the count_matches path (per-position bits + homomorphic
popcount into base-4 digits) warm and cold at any parameter set:

    python benchmarks/count_bench.py                             # 32-bit
    COUNT_PARAMS=TPU64_MESSAGE_2_CARRY_2 python benchmarks/count_bench.py

Env: COUNT_LEN (content length), COUNT_PATTERN, BENCH_ENC=real|trivial.
Decrypt-gated: the decrypted count must equal the plaintext count.
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
    import numpy as np  # noqa: F401
    from bench import _get_keys
    from fhe_regex_tpu import (count_matches, decrypt_count, encrypt_str,
                               trivial_encrypt_str)
    from fhe_regex_tpu.params import TPU_MESSAGE_2_CARRY_2

    params = TPU_MESSAGE_2_CARRY_2
    if "COUNT_PARAMS" in os.environ:
        from fhe_regex_tpu.params import get_params
        params = get_params(os.environ["COUNT_PARAMS"])
    L = int(os.environ.get("COUNT_LEN", "32"))
    pattern = os.environ.get("COUNT_PATTERN", "/abc?/")
    ck, sk = _get_keys(params)

    content = ("abcxabzabcqacw" * ((L + 13) // 14))[:L]
    import re as _re
    body = pattern.strip("/")
    want = sum(1 for i in range(len(content))
               if _re.match(body, content[i:]))
    real = os.environ.get("BENCH_ENC", "trivial") == "real"
    ct = (encrypt_str(ck, content) if real
          else trivial_encrypt_str(params, content))

    t0 = time.time()
    res = count_matches(sk, ct, pattern)
    cold = time.time() - t0
    t0 = time.time()
    res = count_matches(sk, ct, pattern)
    warm = time.time() - t0
    got = decrypt_count(ck, res)
    assert got == want, (got, want)

    print(json.dumps({
        "metric": "count_matches_latency",
        "params": params.name,
        "encryption": "real" if real else "trivial",
        "pattern": pattern, "content_len": L,
        "count": got,
        "cold_s": round(cold, 2), "warm_s": round(warm, 2),
    }))


if __name__ == "__main__":
    main()
