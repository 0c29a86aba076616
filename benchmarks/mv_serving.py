"""Serving throughput with the multi-value (shared-rotation) packed path.

Batched contents vs one pattern, classic vs multivalue run_many.  Wide
packed launches run at the kernel's large-batch throughput, where time is
proportional to the ROTATION count — so the 20-43% rotation sharing on
class/alternation patterns translates to real throughput (unlike the
latency path, where fixed per-launch costs mask it).

Env: SERVE_BATCH (contents, default 32), MV_PATTERN, MV_CONTENT,
MV_FLIP_POS (position mutated to break the match on odd contents; default
0, which breaks the anchored default pattern — set it inside the matched
region for unanchored patterns).
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
                               trivial_encrypt_str, get_params)
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import compile_circuit
    from bench import _get_keys

    params = get_params(os.environ.get(
        "MV_PARAMS", "TPU_MESSAGE_2_CARRY_2"))
    C = int(os.environ.get("SERVE_BATCH", "32"))
    pattern = os.environ.get("MV_PATTERN", "/^(ab|cd)[a-z]{3,}e?$/i")
    base = os.environ.get("MV_CONTENT", "cdqrstuv" + "x" * 55 + "e")
    ck, sk = _get_keys(params)

    flip = int(os.environ.get("MV_FLIP_POS", "0"))
    contents = []
    for i in range(C):
        s = list(base)
        if i % 2:
            s[flip] = "q"       # break the match on odd contents
        contents.append("".join(s))
    real = os.environ.get("BENCH_ENC", "trivial") == "real"
    enc = (lambda c: encrypt_str(ck, c)) if real \
        else (lambda c: trivial_encrypt_str(params, c))
    cts = np.stack([enc(c) for c in contents])
    want = [1 if i % 2 == 0 else 0 for i in range(C)]

    builder, root = compile_match(len(base), pattern, fold="tree")
    mv_c = compile_circuit(params, builder, root, multivalue=True)
    stats = {"pattern": pattern, "batch": C, "content_len": len(base),
             "encryption": "real" if real else "trivial",
             "bootstraps": mv_c.pbs_count, "rotations": mv_c.rotation_count}

    for mv in (False, True):
        res = has_match_many(sk, cts, pattern, multivalue=mv)   # warm
        assert [decrypt(ck, res[i]) for i in range(C)] == want
        t0 = time.time()
        res = has_match_many(sk, cts, pattern, multivalue=mv)
        dt = time.time() - t0
        assert [decrypt(ck, res[i]) for i in range(C)] == want
        stats["mv_steady_s" if mv else "classic_steady_s"] = round(dt, 2)

    stats["speedup"] = round(stats["classic_steady_s"] / stats["mv_steady_s"], 2)
    stats["contents_per_s"] = round(C / stats["mv_steady_s"], 2)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
