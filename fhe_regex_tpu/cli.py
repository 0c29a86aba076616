"""CLI: ``fhe-regex-tpu '<content>' '/<pattern>/'``.

Mirrors the reference binary (src/main.rs): pre-parses the pattern for an
early error, then runs keygen -> encrypt -> has_match -> decrypt and prints
``res: 0|1``.  Logging level via FHE_REGEX_LOG (analog of RUST_LOG,
main.rs:10-11); defaults to info.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None) -> int:
    from fhe_regex_tpu.ops.pbs import BACKENDS

    ap = argparse.ArgumentParser(
        prog="fhe-regex-tpu",
        description="Match a regex against encrypted content (TFHE).",
    )
    ap.add_argument("content", help="plaintext content to encrypt and search")
    ap.add_argument("pattern", help="pattern, e.g. '/^ab?c$/i'")
    ap.add_argument("--params", default=None,
                    help="parameter set name (default: TPU_MESSAGE_2_CARRY_2)")
    ap.add_argument("--trivial", action="store_true",
                    help="use noiseless trivial content encryption (fast test path)")
    ap.add_argument("--backend", default=None,
                    choices=sorted(BACKENDS),
                    help="PBS formulation (default: the measured default "
                         "of the parameter set's torus width)")
    ap.add_argument("--fold", default="reference", choices=["reference", "tree"],
                    help="OR-fold order: reference (counter parity) or tree "
                         "(log-depth, lower latency)")
    ap.add_argument("--engine", default=None, choices=["python", "native"],
                    help="circuit compiler (default: native C++ if built)")
    ap.add_argument("--seed", type=int, default=None, help="keygen seed")
    ap.add_argument("--branch-budget", type=int, default=None,
                    help="cap on circuit branch expansion (clean error "
                         "instead of unbounded compile time)")
    ap.add_argument("--multivalue", action="store_true",
                    help="share blind rotations between same-input ops "
                         "(multi-value bootstrap)")
    ap.add_argument("--count", action="store_true",
                    help="print the NUMBER of matching offsets instead of 0/1")
    ap.add_argument("--positions", action="store_true",
                    help="print one 0/1 per start offset instead of the "
                         "global match bit")
    ap.add_argument("--long", dest="long_", action="store_true",
                    help="windowed long-content matching (fixed circuit "
                         "shape for any content length)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=os.environ.get("FHE_REGEX_LOG", "INFO").upper(),
        format="%(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("fhe_regex_tpu.cli")

    from fhe_regex_tpu.regex.parser import parse, ParseError
    try:
        re = parse(args.pattern)
    except ParseError as e:
        print(f"failed to parse: {e}", file=sys.stderr)
        return 2
    log.info("parsed: %r", re)

    from fhe_regex_tpu import (
        decrypt, encrypt_str, gen_keys, get_params, has_match,
        trivial_encrypt_str,
    )
    from fhe_regex_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    params = get_params(args.params)
    log.info("generating keys (%s)..", params.name)
    client_key, server_key = gen_keys(params, seed=args.seed)

    log.info("encrypting content..")
    try:
        ct_content = (trivial_encrypt_str(params, args.content) if args.trivial
                      else encrypt_str(client_key, args.content))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    log.info("applying regex..")
    from fhe_regex_tpu import (BranchBudgetExceeded, count_matches,
                               decrypt_count, has_match_long,
                               has_match_positions)
    try:
        if args.count:
            if args.multivalue:
                # counting LUT factors fail the mv sigma-margin check, so
                # count_matches always compiles classic — surface that
                # instead of silently ignoring the flag
                print("error: --multivalue is not supported with --count "
                      "(counting LUTs fail the multi-value noise-margin "
                      "check; the count circuit always compiles classic)",
                      file=sys.stderr)
                return 2
            ct_res = count_matches(server_key, ct_content, args.pattern,
                                   backend=args.backend, fold=args.fold,
                                   branch_budget=args.branch_budget)
            print(f"count: {decrypt_count(client_key, ct_res)}")
            return 0
        if args.positions:
            ct_res = has_match_positions(server_key, ct_content, args.pattern,
                                         backend=args.backend, fold=args.fold,
                                         engine=args.engine,
                                         branch_budget=args.branch_budget,
                                         multivalue=args.multivalue or None)
            bits = "".join(str(decrypt(client_key, r)) for r in ct_res)
            print(f"positions: {bits}")
            return 0
        if args.long_:
            ct_res = has_match_long(server_key, ct_content, args.pattern,
                                    backend=args.backend, fold=args.fold,
                                    engine=args.engine,
                                    branch_budget=args.branch_budget,
                                    multivalue=args.multivalue or None)
        else:
            ct_res = has_match(server_key, ct_content, args.pattern,
                               backend=args.backend, fold=args.fold,
                               engine=args.engine,
                               branch_budget=args.branch_budget,
                               multivalue=args.multivalue or None)
    except BranchBudgetExceeded as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    except ValueError as e:   # argument errors (backend/params mismatches)
        print(f"error: {e}", file=sys.stderr)
        return 2
    res = decrypt(client_key, ct_res)
    print(f"res: {res}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
