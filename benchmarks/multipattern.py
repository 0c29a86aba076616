"""Multi-pattern serving: a ruleset vs a content batch in ONE circuit.

has_match_many_patterns compiles the whole pattern set onto one shared
hash-consed DAG, so subexpressions common across patterns (per-position
comparisons, shared prefixes) bootstrap once per content — then run_many
packs every level across contents.  Compares against running each pattern
separately (the only option the single-root API gives you) on:

  - bootstraps: compile-time sharing ratio (joint pbs vs sum of separate)
  - wall time:  steady-state matches/s (C contents x P patterns)

Env: SERVE_BATCH (contents), MP_LEN (content length).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# a realistic keyword/rule set with heavy structural overlap
RULESET = ["/abc/", "/abd/", "/ab/", "/bcd/", "/a.c/", "/ab|cd/",
           "/^abc/", "/bc$/"]


def main():
    from fhe_regex_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import numpy as np
    from fhe_regex_tpu import (decrypt, encrypt_str, has_match_many,
                               has_match_many_patterns,
                               trivial_encrypt_str, _compile_multi)
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.params import TPU_MESSAGE_2_CARRY_2
    from bench import _get_keys

    params = TPU_MESSAGE_2_CARRY_2
    if "MP_PARAMS" in os.environ:        # e.g. TPU64_MESSAGE_2_CARRY_2
        from fhe_regex_tpu.params import get_params
        params = get_params(os.environ["MP_PARAMS"])
    C = int(os.environ.get("SERVE_BATCH", "32"))
    L = int(os.environ.get("MP_LEN", "16"))
    P = len(RULESET)
    ck, sk = _get_keys(params)

    texts = ["xxxxxabcxxxxxxxx", "xxxxxabdxxxxxxxx", "xqxxxxxxxxxxxxcd",
             "xxxxxxxxxxxxxxxx"]
    contents = [(texts[i % len(texts)] * ((L + 15) // 16))[:L]
                for i in range(C)]
    real = os.environ.get("BENCH_ENC", "trivial") == "real"
    enc = (lambda c: encrypt_str(ck, c)) if real \
        else (lambda c: trivial_encrypt_str(params, c))
    cts = np.stack([enc(c) for c in contents])

    # compile-time sharing ratio (bootstraps, engine-independent)
    from fhe_regex_tpu.ops.luts import LutKey  # noqa: F401  (import sanity)
    joint_b, _ = _compile_multi(params, L, RULESET, "tree", None, None)
    joint_pbs = len(joint_b.ops)
    sep_pbs = sum(len(compile_match(L, p, fold="tree")[0].ops)
                  for p in RULESET)

    # joint path: warm then steady-state (MP_MV=1 adds shared rotations)
    mv = os.environ.get("MP_MV") == "1"
    t0 = time.time()
    res = has_match_many_patterns(sk, cts, RULESET, multivalue=mv)
    warm = time.time() - t0
    t0 = time.time()
    res = has_match_many_patterns(sk, cts, RULESET, multivalue=mv)
    joint_s = time.time() - t0

    # separate path (per-pattern run_many), steady-state
    for p in RULESET:
        has_match_many(sk, cts, p)   # warm each circuit
    t0 = time.time()
    sep = [has_match_many(sk, cts, p) for p in RULESET]
    sep_s = time.time() - t0

    # correctness: joint == separate for every (content, pattern)
    for pi in range(P):
        for ci in range(C):
            a = decrypt(ck, res[ci, pi])
            b = decrypt(ck, sep[pi][ci])
            assert a == b, (ci, RULESET[pi], a, b)

    print(json.dumps({
        "metric": "multipattern_serving",
        "encryption": "real" if real else "trivial",
        "multivalue": mv,
        "patterns": P, "batch": C, "content_len": L,
        "joint_pbs": joint_pbs, "separate_pbs": sep_pbs,
        "pbs_sharing_ratio": round(sep_pbs / joint_pbs, 3),
        "first_s": round(warm, 2),
        "joint_steady_s": round(joint_s, 2),
        "separate_steady_s": round(sep_s, 2),
        "speedup_vs_separate": round(sep_s / joint_s, 2),
        "matches_per_s": round(C * P / joint_s, 2),
    }))


if __name__ == "__main__":
    main()
