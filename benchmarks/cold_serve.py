"""Cold-start story: fresh process -> first real encrypted match.

A measured "cold serve-to-first-match" figure an operator can plan
around.  This script runs ONE fresh-process scenario
per invocation (the cold cost is per-process, so scenarios cannot share a
process):

  python benchmarks/cold_serve.py direct   # no warmup: first has_match
                                           # pays executable loads inline
  python benchmarks/cold_serve.py warmup   # serve-style: warmup manifest
                                           # first, then time the match

Reports JSON with the process-start -> result timeline.  Run each with a
warm persistent compile cache (utils/compile_cache.py, the operating
default), or with an empty one for the truly-cold figure.  Uses the
north-star config /^a[b-d]{2,4}e$/i with
REAL client encryption.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

T0 = time.time()                      # process epoch for the timeline
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from fhe_regex_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()

PATTERN = "/^a[b-d]{2,4}e$/i"
CONTENT = "acdde"                     # match = 1 (Q1: [b-d] excludes 'b')


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "direct"
    from bench import _get_keys
    from fhe_regex_tpu import decrypt, encrypt_str
    from fhe_regex_tpu.params import TPU_MESSAGE_2_CARRY_2

    params = TPU_MESSAGE_2_CARRY_2
    ck, sk = _get_keys(params)
    t_keys = time.time() - T0

    timeline = {"mode": mode, "params": params.name,
                "keys_ready_s": round(t_keys, 1)}
    if mode == "warmup":
        from fhe_regex_tpu.serve import MatchService
        svc = MatchService(sk)
        svc.warmup([{"pattern": PATTERN, "content_len": len(CONTENT)}])
        timeline["warmup_done_s"] = round(time.time() - T0, 1)
        ct = encrypt_str(ck, CONTENT)
        t0 = time.time()
        res = svc.match(PATTERN, ct)
        timeline["first_match_latency_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        res = svc.match(PATTERN, ct)
        timeline["steady_match_latency_s"] = round(time.time() - t0, 2)
    else:
        from fhe_regex_tpu import has_match
        ct = encrypt_str(ck, CONTENT)
        t0 = time.time()
        res = has_match(sk, ct, PATTERN)
        timeline["first_match_latency_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        res = has_match(sk, ct, PATTERN)
        timeline["steady_match_latency_s"] = round(time.time() - t0, 2)
    timeline["first_match_done_s"] = round(time.time() - T0, 1)
    assert decrypt(ck, res) == 1
    timeline["decrypt_ok"] = True
    print(json.dumps(timeline))


if __name__ == "__main__":
    main()
