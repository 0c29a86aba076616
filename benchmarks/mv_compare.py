"""Multi-value bootstrap vs classic path: warm e2e latency per config.

Runs each driver config twice per mode (cold compile excluded) and reports
rotations vs bootstraps and the warm-latency ratio.  The multi-value plan
shares one blind rotation between same-input ops (20-43% of rotations on
class/alternation patterns, tests/test_multivalue.py); identical decrypted bits.
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
    from fhe_regex_tpu import (decrypt, encrypt_str, has_match, get_params,
                               trivial_encrypt_str)
    from fhe_regex_tpu.regex.engine import compile_match
    from fhe_regex_tpu.regex.executor import compile_circuit, default_min_bucket
    from bench import _get_keys

    params = get_params("TPU_MESSAGE_2_CARRY_2")
    ck, sk = _get_keys(params)

    cases = [
        ("case_insensitive_classes", "/^[a-d][^xyz]$/i", "bq", 1),
        ("contains_anchors", "/abc/", "xxxxxabcxxxxxxxx", 1),
        ("north_star_hit", "/^a[b-d]{2,4}e$/i", "Acdde", 1),
        ("alternation_combo", "/^(ab|cd)[a-z]{3,}e?$/i",
         "cdqrstuv" + "x" * 55 + "e", 1),
    ]
    for name, pattern, content, want in cases:
        real = os.environ.get("BENCH_ENC", "trivial") == "real"
        ct = (encrypt_str(ck, content) if real
              else trivial_encrypt_str(params, content))
        builder, root = compile_match(len(content), pattern, fold="tree")
        stats = {}
        for mv in (False, True):
            c = compile_circuit(params, builder, root,
                                min_bucket=default_min_bucket(),
                                multivalue=mv)
            stats["rotations" if mv else "bootstraps"] = (
                c.rotation_count if mv else c.pbs_count)
            lat = []
            for _ in range(2):
                t0 = time.time()
                res = has_match(sk, ct, pattern, fold="tree", multivalue=mv)
                got = decrypt(ck, res)
                lat.append(time.time() - t0)
                assert got == want, (name, mv, got)
            stats["mv_warm_s" if mv else "classic_warm_s"] = round(lat[-1], 3)
        stats.update({
            "config": name,
            "rotation_share_saved": round(
                1 - stats["rotations"] / stats["bootstraps"], 3),
            "speedup": round(stats["classic_warm_s"] / stats["mv_warm_s"], 2),
        })
        print(json.dumps(stats), flush=True)


if __name__ == "__main__":
    main()
