"""End-to-end encrypted-match latency over the 5 BASELINE.json configs,
on whatever platform JAX finds.

Usage:  python benchmarks/e2e.py [--params NAME] [--fold tree|reference]
Writes one JSON line per config, each result checked against the plaintext
dialect oracle (the headline bench.py metric stays bootstraps/s/chip).
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
    ap.add_argument("--params", default=None)
    ap.add_argument("--fold", default="tree")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--trivial", action="store_true",
                    help="trivial content encryption (deterministic fast path)")
    ap.add_argument("--repeat", type=int, default=0,
                    help="extra warm runs per config (reports warm min)")
    args = ap.parse_args()
    import numpy as np
    from fhe_regex_tpu import (decrypt, encrypt_str, has_match, get_params,
                               trivial_encrypt_str)
    from fhe_regex_tpu.models.patterns import (BASELINE_CONFIGS,
                                               BASELINE_CONTENTS, NORTH_STAR)
    from fhe_regex_tpu.regex.oracle import oracle_match
    from bench import _get_keys

    params = get_params(args.params or "TPU_MESSAGE_2_CARRY_2")
    ck, sk = _get_keys(params)

    contents = dict(BASELINE_CONTENTS)
    configs = BASELINE_CONFIGS + [
        NORTH_STAR,
        # the north-star pattern on content it CAN match ([b-d] excludes
        # 'b' by Q1, so the repeats must be c/d)
        {"name": "north_star_hit", "pattern": NORTH_STAR["pattern"],
         "content_len": 5},
    ]
    contents["north_star_hit"] = "Acdde"
    expected = {c["name"]: oracle_match(contents[c["name"]], c["pattern"])
                for c in configs}

    for cfg in configs:
        name = cfg["name"]
        content = contents[name]
        assert len(content) == cfg["content_len"], (name, len(content))
        ct = (trivial_encrypt_str(params, content) if args.trivial
              else encrypt_str(ck, content))
        t0 = time.time()
        res = has_match(sk, ct, cfg["pattern"], backend=args.backend,
                        fold=args.fold)
        got = decrypt(ck, res)
        dt = time.time() - t0
        warm = None
        for _ in range(args.repeat):
            t0 = time.time()
            res = has_match(sk, ct, cfg["pattern"], backend=args.backend,
                            fold=args.fold)
            w = time.time() - t0
            warm = w if warm is None else min(warm, w)
            assert decrypt(ck, res) == got
        rec = {
            "config": name, "pattern": cfg["pattern"],
            "content_len": cfg["content_len"],
            "latency_s": round(dt, 3), "result": got,
            "expected": expected[name], "ok": got == expected[name],
            "fold": args.fold, "params": params.name,
        }
        if warm is not None:
            rec["warm_s"] = round(warm, 3)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
