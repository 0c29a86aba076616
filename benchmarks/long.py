"""Long-content matching: direct circuit vs windowed (has_match_long).

The direct circuit's op count, branch enumeration, and executable slab
shape grow with content length; the windowed path compiles ONE window
circuit (reusing the serving launch shapes) and packs windows through
run_many.  Reports both latencies and the direct circuit's growth.

Env: LONG_LEN (content length, default 256), LONG_WINDOW (default 64),
LONG_PATTERN (default /abc/ + a needle near the end).
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
    from fhe_regex_tpu import (decrypt, encrypt_str, has_match,
                               has_match_long, get_params,
                               trivial_encrypt_str)
    from bench import _get_keys

    params = get_params(os.environ.get(
        "LONG_PARAMS", "TPU_MESSAGE_2_CARRY_2"))
    L = int(os.environ.get("LONG_LEN", "256"))
    W = int(os.environ.get("LONG_WINDOW", "64"))
    pattern = os.environ.get("LONG_PATTERN", "/abc/")
    ck, sk = _get_keys(params)

    content = "x" * (L - 8) + "abcxxxxx"
    real = os.environ.get("BENCH_ENC", "trivial") == "real"
    ct = encrypt_str(ck, content) if real \
        else trivial_encrypt_str(params, content)

    t0 = time.time()
    res_w = has_match_long(sk, ct, pattern, window=W)
    windowed_cold = time.time() - t0
    t0 = time.time()
    res_w = has_match_long(sk, ct, pattern, window=W)
    windowed = time.time() - t0
    assert decrypt(ck, res_w) == 1

    t0 = time.time()
    res_d = has_match(sk, ct, pattern)
    direct_cold = time.time() - t0
    t0 = time.time()
    res_d = has_match(sk, ct, pattern)
    direct = time.time() - t0
    assert decrypt(ck, res_d) == 1

    print(json.dumps({
        "metric": "long_content", "pattern": pattern, "content_len": L,
        "encryption": "real" if real else "trivial",
        "window": W,
        "windowed_cold_s": round(windowed_cold, 2),
        "windowed_warm_s": round(windowed, 2),
        "direct_cold_s": round(direct_cold, 2),
        "direct_warm_s": round(direct, 2),
        "speedup_warm": round(direct / windowed, 2),
    }))


if __name__ == "__main__":
    main()
