"""fhe-regex-tpu: TFHE gate evaluation + encrypted regex matching in JAX.

Public API mirrors the reference's library surface (tutorial.md:12-37 /
src/regex/mod.rs): ``gen_keys -> encrypt_str -> has_match -> decrypt``.
The result of ``has_match`` is an encrypted 0/1 only the client key opens.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from fhe_regex_tpu.params import Params, get_params
from fhe_regex_tpu.crypto.keys import (
    ClientKey,
    ServerKey,
    gen_keys,
    load_client_key,
    save_client_key,
    server_key_from_client,
)
from fhe_regex_tpu.crypto import lwe as _lwe
from fhe_regex_tpu.regex.circuit import CircuitBuilder, Node
from fhe_regex_tpu.regex.engine import BranchBudgetExceeded, compile_match
from fhe_regex_tpu.regex.executor import (CompiledCircuit, Executor,
                                          compile_circuit)
from fhe_regex_tpu.ops.pbs import prepare_server_key, resolve_backend

__all__ = [
    "Params",
    "get_params",
    "ClientKey",
    "ServerKey",
    "gen_keys",
    "server_key_from_client",
    "save_client_key",
    "load_client_key",
    "encrypt_str",
    "trivial_encrypt_str",
    "has_match",
    "has_match_many",
    "has_match_patterns",
    "has_match_many_patterns",
    "has_match_positions",
    "has_match_many_positions",
    "has_match_long",
    "has_match_many_long",
    "count_matches",
    "decrypt_count",
    "decrypt",
    "compile_match",
    "BranchBudgetExceeded",
    "compile_circuit",
    "Executor",
    "CircuitBuilder",
    "Node",
    "executor_for",
    "run_circuit",
]

logger = logging.getLogger("fhe_regex_tpu")


def encrypt_str(client_key: ClientKey, s: str) -> np.ndarray:
    """ASCII string -> [len, num_blocks, n+1] uint32 (ciphertext.rs:32-40)."""
    if not s.isascii():
        raise ValueError("content contains non-ascii characters")
    p = client_key.params
    if not s:
        return np.zeros((0, p.num_blocks, p.lwe_dimension + 1), np.uint32)
    return np.stack(
        [_lwe.encrypt_byte(p, client_key.lwe_key, b, client_key.rng)
         for b in s.encode("ascii")]
    )


def trivial_encrypt_str(params: Params, s: str) -> np.ndarray:
    """Noiseless content encoding — the reference's test fast path
    (create_trivial_radix per byte, engine.rs:282-286)."""
    if not s.isascii():
        raise ValueError("content contains non-ascii characters")
    if not s:
        return np.zeros((0, params.num_blocks, params.lwe_dimension + 1), np.uint32)
    return np.stack([_lwe.trivial_byte(params, b) for b in s.encode("ascii")])


def _executor_for(server_key: ServerKey, backend: Optional[str],
                  mesh=None) -> Executor:
    from fhe_regex_tpu.params import warn_if_unsafe

    warn_if_unsafe(server_key.params, "executor_for")
    backend = resolve_backend(backend, server_key.params)
    cache = getattr(server_key, "_executor_cache", None)
    if cache is None:
        cache = {}
        server_key._executor_cache = cache
    key = (backend, id(mesh) if mesh is not None else None)
    if key not in cache:
        dev_key = prepare_server_key(server_key.params, server_key, backend)
        cache[key] = Executor(server_key.params, dev_key, mesh=mesh)
    return cache[key]


def has_match(server_key: ServerKey, ct_content: np.ndarray, pattern: str,
              backend: Optional[str] = None, mesh=None,
              fold: str = "reference",
              engine: Optional[str] = None,
              branch_budget: Optional[int] = None,
              multivalue: Optional[bool] = None) -> np.ndarray:
    """Encrypted match: does `pattern` match the encrypted content?

    Mirrors ``engine::has_match`` (engine.rs:8-42): returns a radix ciphertext
    encrypting 1 (match) or 0 (no match).  ``backend`` selects the PBS
    formulation (ops/pbs.BACKENDS; None = the width's default); ``mesh``
    shards each level's bootstrap batch across devices; ``fold='tree'``
    replaces the reference's sequential OR fold with a log-depth tree
    (same decrypted result, far lower latency); ``engine`` selects the
    circuit compiler ('python' / 'native' C++ / None = native if built —
    byte-exact parity is test-enforced); ``branch_budget`` bounds variant
    expansion (exponential for nested quantifiers) with a clean
    BranchBudgetExceeded instead of unbounded compile time.
    """
    from fhe_regex_tpu.regex.executor import default_min_bucket

    params = server_key.params
    if engine is None:
        from fhe_regex_tpu.regex.native import default_engine
        engine = default_engine()
    if engine == "native":
        from fhe_regex_tpu.regex.native import compile_match_native
        builder, root = compile_match_native(
            len(ct_content), pattern, num_blocks=params.num_blocks, fold=fold,
            branch_budget=branch_budget)
    else:
        builder, root = compile_match(len(ct_content), pattern,
                                      num_blocks=params.num_blocks, fold=fold,
                                      branch_budget=branch_budget)
    min_bucket = default_min_bucket()
    if mesh is not None:
        min_bucket = max(min_bucket, int(mesh.devices.size))
    circuit = compile_circuit(params, builder, root, min_bucket=min_bucket,
                              multivalue=_resolve_multivalue(
                                  multivalue, params, mesh))
    executor = _executor_for(server_key, backend, mesh)
    result = executor.run(circuit, np.ascontiguousarray(ct_content))
    logger.info(
        "%d ciphertext operations, %d cache hits (%d bootstraps in %d levels)",
        circuit.ct_ops, circuit.cache_hits, circuit.pbs_count, len(circuit.levels),
    )
    return result


def has_match_many(server_key: ServerKey, ct_contents, pattern: str,
                   backend: Optional[str] = None, fold: str = "tree",
                   engine: Optional[str] = None,
                   branch_budget: Optional[int] = None,
                   wide_batch: Optional[bool] = None,
                   multivalue: Optional[bool] = None) -> np.ndarray:
    """Match one pattern against many equal-length encrypted contents.

    The serving fast path: the compiled circuit is shared and every level's
    bootstrap batch spans all contents.  Returns [C, num_blocks, n+1].
    ``wide_batch`` enables the WIDE_LEVEL_BATCH launch shape for big packed
    levels (default WIDE_BATCH; see Executor.run_many).
    """
    params = server_key.params
    contents = np.ascontiguousarray(ct_contents)
    if contents.ndim != 4:
        raise ValueError("expected [C, len, num_blocks, n+1] contents")
    if engine is None:
        from fhe_regex_tpu.regex.native import default_engine
        engine = default_engine()
    if engine == "native":
        from fhe_regex_tpu.regex.native import compile_match_native
        builder, root = compile_match_native(
            contents.shape[1], pattern, num_blocks=params.num_blocks, fold=fold,
            branch_budget=branch_budget)
    else:
        builder, root = compile_match(contents.shape[1], pattern,
                                      num_blocks=params.num_blocks, fold=fold,
                                      branch_budget=branch_budget)
    circuit = _compile_auto_mv(params, builder, root,
                               _resolve_multivalue(multivalue, params, None,
                                                   packed=True))
    executor = _executor_for(server_key, backend)
    result = executor.run_many(circuit, contents, wide_batch=wide_batch)
    logger.info(
        "%d contents x (%d ops, %d bootstraps in %d levels)",
        contents.shape[0], circuit.ct_ops, circuit.pbs_count, len(circuit.levels),
    )
    return result


def _resolve_multivalue(multivalue: Optional[bool], params: Params,
                        mesh, packed: bool = False) -> Optional[bool]:
    """multivalue default: explicit arg > FHE_REGEX_MULTIVALUE env > auto.

    The multi-value plan (ops/mv.py) shares blind rotations between ops
    with identical inputs — fewer rotations, identical decrypted results,
    and the noise margin holds at both torus widths (blind-rotation noise
    is the only amplified term; tests/test_multivalue.py).  Sharded under
    a mesh via parallel/mesh.make_sharded_mv_core.

    On the PACKED serving paths (run_many: levels packed across contents)
    wall time is proportional to the ROTATION count, so multivalue is
    AUTO-enabled there when the compiled circuit's rotation savings clear
    ``MV_AUTO_MIN_SAVINGS`` and the sigma-margin check passes (returns
    None = "decide from the compiled circuit", see _compile_auto_mv).
    Single-content latency is ~neutral under multivalue (padded rotation
    rows cost the same as real ones at executor widths) and each fresh
    process pays extra executable-shape loads for the mv level functions,
    so non-packed paths stay classic unless opted in."""
    import os

    del params, mesh   # supported at both widths and under a mesh
    if multivalue is not None:
        return bool(multivalue)
    env = os.environ.get("FHE_REGEX_MULTIVALUE")
    if env == "1":
        return True
    if env == "0":
        return False
    return None if packed else False


# Minimum fraction of blind rotations a compiled circuit must save for the
# packed serving paths to auto-enable the multi-value plan: packed serving
# time follows the rotation count, and below ~15% the extra executable
# shapes aren't worth it (not yet re-measured on the GPU).  Env override:
# FHE_REGEX_MV_MIN_SAVINGS.
MV_AUTO_MIN_SAVINGS = 0.15


def _compile_auto_mv(params: Params, builder, roots, multivalue, **kw):
    """compile_circuit with the packed-path multivalue auto-default.

    multivalue True/False compiles that plan directly.  None ("auto")
    compiles the multi-value plan first and keeps it when the rotation
    savings clear MV_AUTO_MIN_SAVINGS; otherwise (including when a LUT
    factor fails the >=5 sigma margin check) compiles classic."""
    import os

    from fhe_regex_tpu.regex.executor import MvMarginError

    if multivalue is not None:
        return compile_circuit(params, builder, roots, multivalue=multivalue,
                               **kw)
    try:
        mv_c = compile_circuit(params, builder, roots, multivalue=True, **kw)
    except MvMarginError as e:
        # the one *expected* rejection (a LUT factor under 5 sigma); any
        # other error is a genuine bug and must propagate
        logger.info("mv auto: falling back to classic plan (%s)", e)
        return compile_circuit(params, builder, roots, multivalue=False, **kw)
    raw = os.environ.get("FHE_REGEX_MV_MIN_SAVINGS")
    try:
        threshold = (float(raw) if raw is not None
                     else MV_AUTO_MIN_SAVINGS)
    except ValueError:
        logger.warning("bad FHE_REGEX_MV_MIN_SAVINGS=%r; using default %.2f",
                       raw, MV_AUTO_MIN_SAVINGS)
        threshold = MV_AUTO_MIN_SAVINGS
    pbs = mv_c.pbs_count
    if pbs and (1.0 - mv_c.rotation_count / pbs) >= threshold:
        return mv_c
    return compile_circuit(params, builder, roots, multivalue=False, **kw)


def executor_for(server_key: ServerKey, backend: Optional[str] = None,
                 mesh=None) -> Executor:
    """A (cached) Executor bound to this server key's device material.

    The entry point for running CUSTOM circuits: build a gate DAG with
    ``CircuitBuilder`` (the public twin of the reference's ``Execution``
    context, execution.rs:46-222 — ``ct_eq / ct_ge / ct_le / ct_and /
    ct_or / ct_not / ct_true / ct_false / ct_constant`` plus the
    ``ct_ops`` / ``cache_hits`` counters), compile it with
    ``compile_circuit``, then ``executor.run(circuit, ct_content)``.
    Executors are cached on the key per (backend, mesh), so repeated calls
    reuse the device upload.
    """
    return _executor_for(server_key, backend, mesh)


def run_circuit(server_key: ServerKey, builder: CircuitBuilder, root,
                ct_content: np.ndarray, backend: Optional[str] = None,
                mesh=None) -> np.ndarray:
    """One-shot compile + execute of a custom CircuitBuilder DAG.

    ``root`` is one Node (result ``[num_blocks, n+1]``) or a list of Nodes
    (result ``[R, num_blocks, n+1]``); pending gate nodes are forced
    automatically.  For repeated serving of the same circuit, compile once
    with ``compile_circuit`` and reuse an ``executor_for`` instead.
    """
    from fhe_regex_tpu.regex.executor import default_min_bucket

    params = server_key.params
    if isinstance(root, (list, tuple)):
        root = [builder.force_node(r) for r in root]
    else:
        root = builder.force_node(root)
    min_bucket = default_min_bucket()
    if mesh is not None:
        min_bucket = max(min_bucket, int(mesh.devices.size))
    circuit = compile_circuit(params, builder, root, min_bucket=min_bucket)
    executor = _executor_for(server_key, backend, mesh)
    return executor.run(circuit, np.ascontiguousarray(ct_content))


def _compile_multi(params: Params, content_len: int, patterns,
                   fold: str, engine: Optional[str],
                   branch_budget: Optional[int]):
    patterns = list(patterns)
    if not patterns:
        raise ValueError("need at least one pattern")
    if engine is None:
        from fhe_regex_tpu.regex.native import default_engine
        engine = default_engine()
    if engine == "native":
        from fhe_regex_tpu.regex.native import compile_match_native_multi
        return compile_match_native_multi(
            content_len, patterns, num_blocks=params.num_blocks, fold=fold,
            branch_budget=branch_budget)
    from fhe_regex_tpu.regex.engine import compile_match_multi
    return compile_match_multi(content_len, patterns,
                               num_blocks=params.num_blocks, fold=fold,
                               branch_budget=branch_budget)


def _compile_positions(params: Params, content_len: int, pattern: str,
                       fold: str, engine: Optional[str],
                       branch_budget: Optional[int]):
    if engine is None:
        from fhe_regex_tpu.regex.native import default_engine
        engine = default_engine()
    if engine == "native":
        from fhe_regex_tpu.regex.native import compile_match_native_positions
        return compile_match_native_positions(
            content_len, pattern, num_blocks=params.num_blocks, fold=fold,
            branch_budget=branch_budget)
    from fhe_regex_tpu.regex.engine import compile_match_positions
    return compile_match_positions(content_len, pattern,
                                   num_blocks=params.num_blocks, fold=fold,
                                   branch_budget=branch_budget)


def has_match_patterns(server_key: ServerKey, ct_content: np.ndarray,
                       patterns, backend: Optional[str] = None, mesh=None,
                       fold: str = "tree", engine: Optional[str] = None,
                       branch_budget: Optional[int] = None,
                       multivalue: Optional[bool] = None) -> np.ndarray:
    """Match MANY patterns against one encrypted content in one circuit.

    All patterns share a single hash-consed op DAG, so subexpressions common
    across patterns (per-position comparisons, shared prefixes/classes) are
    bootstrapped once — the cross-pattern generalization of the reference's
    per-call memo cache (execution.rs:212-222).  Returns one radix ciphertext
    per pattern, `[P, num_blocks, n+1]`, in pattern order; decrypt each with
    ``decrypt``.
    """
    from fhe_regex_tpu.regex.executor import default_min_bucket

    params = server_key.params
    builder, roots = _compile_multi(params, len(ct_content), patterns,
                                    fold, engine, branch_budget)
    min_bucket = default_min_bucket()
    if mesh is not None:
        min_bucket = max(min_bucket, int(mesh.devices.size))
    circuit = compile_circuit(params, builder, roots, min_bucket=min_bucket,
                              multivalue=_resolve_multivalue(
                                  multivalue, params, mesh))
    executor = _executor_for(server_key, backend, mesh)
    result = executor.run(circuit, np.ascontiguousarray(ct_content))
    logger.info(
        "%d patterns: %d ciphertext operations, %d cache hits "
        "(%d bootstraps in %d levels)",
        len(roots), circuit.ct_ops, circuit.cache_hits, circuit.pbs_count,
        len(circuit.levels),
    )
    return result


def has_match_positions(server_key: ServerKey, ct_content: np.ndarray,
                        pattern: str, backend: Optional[str] = None,
                        mesh=None, fold: str = "tree",
                        engine: Optional[str] = None,
                        branch_budget: Optional[int] = None,
                        multivalue: Optional[bool] = None) -> np.ndarray:
    """Per-offset encrypted match bits: result[i] encrypts 1 iff the pattern
    matches starting at content position i.

    The reference folds all start positions into one global OR
    (engine.rs:15-35); this keeps each position's OR separate — an
    encrypted "grep with offsets".  `has_match`'s bit is the OR of these.
    Returns `[len, num_blocks, n+1]`; decrypt each row with ``decrypt``.
    """
    from fhe_regex_tpu.regex.executor import default_min_bucket

    params = server_key.params
    builder, roots = _compile_positions(params, len(ct_content), pattern,
                                        fold, engine, branch_budget)
    min_bucket = default_min_bucket()
    if mesh is not None:
        min_bucket = max(min_bucket, int(mesh.devices.size))
    circuit = compile_circuit(params, builder, roots, min_bucket=min_bucket,
                              multivalue=_resolve_multivalue(
                                  multivalue, params, mesh))
    executor = _executor_for(server_key, backend, mesh)
    result = executor.run(circuit, np.ascontiguousarray(ct_content))
    logger.info(
        "%d positions: %d ciphertext operations, %d cache hits "
        "(%d bootstraps in %d levels)",
        len(roots), circuit.ct_ops, circuit.cache_hits, circuit.pbs_count,
        len(circuit.levels),
    )
    return result


def has_match_many_patterns(server_key: ServerKey, ct_contents, patterns,
                            backend: Optional[str] = None, fold: str = "tree",
                            engine: Optional[str] = None,
                            branch_budget: Optional[int] = None,
                            wide_batch: Optional[bool] = None,
                            multivalue: Optional[bool] = None) -> np.ndarray:
    """Match MANY patterns against MANY equal-length encrypted contents.

    The full serving cross product in one compiled circuit: pattern-shared
    subexpressions are bootstrapped once per content, and every level's
    bootstrap batch spans all contents.  Returns `[C, P, num_blocks, n+1]`.
    """
    params = server_key.params
    contents = np.ascontiguousarray(ct_contents)
    if contents.ndim != 4:
        raise ValueError("expected [C, len, num_blocks, n+1] contents")
    builder, roots = _compile_multi(params, contents.shape[1], patterns,
                                    fold, engine, branch_budget)
    circuit = _compile_auto_mv(params, builder, roots,
                               _resolve_multivalue(multivalue, params, None,
                                                   packed=True))
    executor = _executor_for(server_key, backend)
    result = executor.run_many(circuit, contents, wide_batch=wide_batch)
    logger.info(
        "%d contents x %d patterns (%d ops, %d bootstraps in %d levels)",
        contents.shape[0], len(roots), circuit.ct_ops, circuit.pbs_count,
        len(circuit.levels),
    )
    return result


def has_match_many_positions(server_key: ServerKey, ct_contents,
                             pattern: str, backend: Optional[str] = None,
                             fold: str = "tree",
                             engine: Optional[str] = None,
                             branch_budget: Optional[int] = None,
                             wide_batch: Optional[bool] = None,
                             multivalue: Optional[bool] = None) -> np.ndarray:
    """Per-offset match bits for MANY equal-length encrypted contents.

    The batched-serving form of ``has_match_positions``: one compiled
    multi-root circuit, levels packed across contents.  Returns
    ``[C, len, num_blocks, n+1]``.
    """
    params = server_key.params
    contents = np.ascontiguousarray(ct_contents)
    if contents.ndim != 4:
        raise ValueError("expected [C, len, num_blocks, n+1] contents")
    builder, roots = _compile_positions(params, contents.shape[1], pattern,
                                        fold, engine, branch_budget)
    circuit = _compile_auto_mv(params, builder, roots,
                               _resolve_multivalue(multivalue, params, None,
                                                   packed=True))
    executor = _executor_for(server_key, backend)
    result = executor.run_many(circuit, contents, wide_batch=wide_batch)
    logger.info(
        "%d contents x %d positions (%d ops, %d bootstraps in %d levels)",
        contents.shape[0], len(roots), circuit.ct_ops, circuit.pbs_count,
        len(circuit.levels),
    )
    return result


def _or_reduce_bits(server_key: ServerKey, backend: Optional[str],
                    bits: np.ndarray) -> np.ndarray:
    """Homomorphic OR of M encrypted result bits -> one radix ciphertext.

    bits [M, num_blocks, n+1]: block-0 rows carry the 0/1 (the executor's
    root convention).  Log3-depth rounds of batched OR2/OR3 bootstraps,
    chunked onto the executor's launch shapes (one executable per shape).
    """
    import jax.numpy as jnp

    from fhe_regex_tpu.crypto.golden import make_lut_poly
    from fhe_regex_tpu.ops.luts import LUT_OR2, LUT_OR3, lut_fn
    from fhe_regex_tpu.regex.executor import (MAX_LEVEL_BATCH,
                                              SMALL_LEVEL_BATCH, _bucket,
                                              _chunk_sizes, _limbs_to_np,
                                              _np_to_limbs,
                                              default_min_bucket)

    params = server_key.params
    ex = _executor_for(server_key, backend)
    tb = params.torus_bits
    luts = np.stack([make_lut_poly(params, lut_fn(LUT_OR2)),
                     make_lut_poly(params, lut_fn(LUT_OR3))])
    luts_dev = jnp.asarray(_np_to_limbs(luts, tb))
    rows = np.ascontiguousarray(bits[:, 0, :])          # [M, n+1]
    while rows.shape[0] > 1:
        g = [rows[i:i + 3] for i in range(0, rows.shape[0], 3)]
        carry = [grp for grp in g if grp.shape[0] == 1]
        work = [grp for grp in g if grp.shape[0] > 1]
        # rows > 1 guarantees the first group has >= 2 elements
        assert work, "reduction round with no pairs"
        x = _np_to_limbs(np.stack([grp[0] for grp in work]), tb)
        idx = []
        dt = np.uint32 if tb == 32 else np.uint64
        for j, grp in enumerate(work):
            with np.errstate(over="ignore"):
                v = grp[0].astype(dt) + dt(2) * grp[1].astype(dt)
                if grp.shape[0] == 3:
                    v = v + dt(4) * grp[2].astype(dt)
            x[j] = v.view(np.int32) if tb == 32 else _np_to_limbs(v, tb)
            idx.append(0 if grp.shape[0] == 2 else 1)
        B = len(work)
        pad = default_min_bucket()
        if pad >= SMALL_LEVEL_BATCH:         # two-shape scheme {SMALL, MAX}
            sizes = _chunk_sizes(B, False)
        else:                                # power-of-two buckets
            sizes = [MAX_LEVEL_BATCH] * (B // MAX_LEVEL_BATCH)
            if B % MAX_LEVEL_BATCH:
                sizes.append(_bucket(B % MAX_LEVEL_BATCH, pad))
        total = sum(sizes)
        xp = np.zeros((total,) + x.shape[1:], np.int32)
        xp[:B] = x
        idxp = np.zeros(total, np.int32)
        idxp[:B] = idx
        outs, c0 = [], 0
        for w in sizes:
            outs.append(np.asarray(ex._core(
                ex._key_args, luts_dev, jnp.asarray(idxp[c0:c0 + w]),
                jnp.asarray(xp[c0:c0 + w]))))
            c0 += w
        out = np.concatenate(outs)[:B]
        rows = np.concatenate([_limbs_to_np(out, tb)] + carry)
    n1 = params.lwe_dimension + 1
    res = np.zeros((params.num_blocks, n1), rows.dtype)
    res[0] = rows[0]
    return res


def _window_plan(span: int, L: int, window: Optional[int]):
    """Shared window layout for long-content matching: (W, starts).

    Default W is at least 2*span so the stride (W - span) stays >= span;
    the final window is flush with the content end.  Returns W >= L (and
    no starts) when windowing cannot help."""
    W = window if window is not None else max(2 * span, span + 1,
                                              min(64, L))
    W = min(max(W, span + 1), L)
    if W >= L:
        return W, []
    S = W - span
    return W, sorted({*range(0, L - W, S), L - W})


def has_match_long(server_key: ServerKey, ct_content: np.ndarray,
                   pattern: str, window: Optional[int] = None,
                   backend: Optional[str] = None, fold: str = "tree",
                   engine: Optional[str] = None,
                   branch_budget: Optional[int] = None,
                   wide_batch: Optional[bool] = None,
                   multivalue: Optional[bool] = None) -> np.ndarray:
    """Match over LONG encrypted content via overlapping windows.

    The direct circuit's size (and compile time, and executable shapes)
    grows with the content length.  When the pattern's maximum match span
    is bounded (engine.max_match_span), any match fits inside a fixed-size
    window, so the content is scanned as overlapping windows (stride =
    window - span) batched through ``run_many`` — one compiled circuit
    regardless of content length — and the window bits are OR-reduced
    homomorphically.  Decrypts identically to ``has_match`` on the full
    content (window boundaries replicate the engine's bounds-pruning
    semantics: interior windows give every start `span` headroom, and the
    final window is flush with the content end).

    Anchored patterns reduce to single flush windows (`^`: the first
    span+1 chars; `$`: the last span chars; both: impossible beyond the
    span — trivial FALSE, exactly the reference's all-branches-pruned
    result).  Unbounded-span patterns (an unquantified-max repetition,
    capped by content length per Q7) fall back to the direct circuit.
    """
    from fhe_regex_tpu.regex import parser as _P
    from fhe_regex_tpu.regex.engine import has_anchor, max_match_span
    from fhe_regex_tpu.regex.parser import parse as _parse

    params = server_key.params
    content = np.ascontiguousarray(ct_content)
    L = content.shape[0]
    re = _parse(pattern)
    span = max_match_span(re)

    def direct(ct):
        return has_match(server_key, ct, pattern, backend=backend, fold=fold,
                         engine=engine, branch_budget=branch_budget,
                         multivalue=multivalue)

    if span is None or L == 0:
        return direct(content)
    sof = has_anchor(re, _P.SOF)
    eof = has_anchor(re, _P.EOF)
    if sof and eof:
        if L <= span:
            return direct(content)
        # the anchored pattern must span all L chars but can consume at
        # most `span` — every branch is pruned, exactly as in the direct
        # circuit: trivial FALSE
        n1 = params.lwe_dimension + 1
        dt = np.uint32 if params.torus_bits == 32 else np.uint64
        return np.zeros((params.num_blocks, n1), dt)
    if sof:
        return direct(content[:min(L, span + 1)])
    if eof:
        return direct(content[L - min(L, max(span, 1)):])

    W, starts = _window_plan(span, L, window)
    if not starts:
        return direct(content)
    wins = np.stack([content[a:a + W] for a in starts])
    bits = has_match_many(server_key, wins, pattern, backend=backend,
                          fold=fold, engine=engine,
                          branch_budget=branch_budget,
                          wide_batch=wide_batch, multivalue=multivalue)
    logger.info("long content: %d chars -> %d windows of %d (span %d)",
                L, len(starts), W, span)
    return _or_reduce_bits(server_key, backend, bits)


def has_match_many_long(server_key: ServerKey, ct_contents,
                        pattern: str, window: Optional[int] = None,
                        backend: Optional[str] = None, fold: str = "tree",
                        engine: Optional[str] = None,
                        branch_budget: Optional[int] = None,
                        wide_batch: Optional[bool] = None,
                        multivalue: Optional[bool] = None) -> np.ndarray:
    """Windowed matching over MANY equal-length long encrypted contents.

    The batched form of ``has_match_long``: the windows of every document
    pack into ONE ``run_many`` batch (levels amortize across all windows of
    all documents), then each document's window bits OR-reduce.  Returns
    ``[C, num_blocks, n+1]``.  Anchored / unbounded-span patterns reduce to
    a single batched ``has_match_many`` launch over the (possibly trimmed)
    documents — no windowing needed, still one launch for all C.
    """
    from fhe_regex_tpu.regex import parser as _P
    from fhe_regex_tpu.regex.engine import has_anchor, max_match_span
    from fhe_regex_tpu.regex.parser import parse as _parse

    params = server_key.params
    contents = np.ascontiguousarray(ct_contents)
    if contents.ndim != 4:
        raise ValueError("expected [C, len, num_blocks, n+1] contents")
    C, L = contents.shape[0], contents.shape[1]
    re = _parse(pattern)
    span = max_match_span(re)

    def batched(cts):
        return has_match_many(server_key, cts, pattern, backend=backend,
                              fold=fold, engine=engine,
                              branch_budget=branch_budget,
                              wide_batch=wide_batch, multivalue=multivalue)

    if span is None or L == 0:
        return batched(contents)
    sof = has_anchor(re, _P.SOF)
    eof = has_anchor(re, _P.EOF)
    # anchored patterns reduce to ONE flush window per document — still a
    # single batched launch over all documents
    if sof and eof:
        if L <= span:
            return batched(contents)
        n1 = params.lwe_dimension + 1
        dt = np.uint32 if params.torus_bits == 32 else np.uint64
        return np.zeros((C, params.num_blocks, n1), dt)
    if sof:
        return batched(contents[:, :min(L, span + 1)])
    if eof:
        return batched(contents[:, L - min(L, max(span, 1)):])

    W, starts = _window_plan(span, L, window)
    if not starts:
        return batched(contents)
    M = len(starts)
    wins = np.stack([contents[c, a:a + W] for c in range(C) for a in starts])
    bits = has_match_many(server_key, wins, pattern, backend=backend,
                          fold=fold, engine=engine,
                          branch_budget=branch_budget,
                          wide_batch=wide_batch, multivalue=multivalue)
    logger.info("%d long contents: %d chars -> %d windows of %d each",
                C, L, M, W)
    return np.stack([
        _or_reduce_bits(server_key, backend, bits[c * M:(c + 1) * M])
        for c in range(C)])


def count_matches(server_key: ServerKey, ct_content: np.ndarray,
                  pattern: str, backend: Optional[str] = None,
                  fold: str = "tree",
                  branch_budget: Optional[int] = None) -> np.ndarray:
    """Encrypted NUMBER of matching start offsets.

    Builds the per-position match bits (has_match_positions' circuit) and
    sums them homomorphically into little-endian base-4 digits
    (circuit.count_bits: a log-depth popcount + ripple-carry adder tree).
    Returns ``[D, num_blocks, n+1]`` — decrypt with ``decrypt_count``.
    The count reveals strictly more than the reference's 0/1 (still only
    to the key holder); the match bit is `count > 0`.
    """
    from fhe_regex_tpu.regex.circuit import Node, count_bits
    from fhe_regex_tpu.regex.engine import compile_match_positions
    from fhe_regex_tpu.regex.executor import default_min_bucket

    params = server_key.params
    # the Python builder (count_bits appends ops to it); counting LUTs are
    # non-boolean, so the circuit compiles classic (no multivalue)
    builder, roots = compile_match_positions(
        len(ct_content), pattern, num_blocks=params.num_blocks, fold=fold,
        branch_budget=branch_budget)
    digits = count_bits(builder, roots)
    digit_roots = [Node(("count", i), d) for i, d in enumerate(digits)]
    circuit = compile_circuit(params, builder, digit_roots,
                              min_bucket=default_min_bucket())
    executor = _executor_for(server_key, backend)
    result = executor.run(circuit, np.ascontiguousarray(ct_content))
    logger.info(
        "count over %d positions: %d digits (%d bootstraps in %d levels)",
        len(roots), len(digits), circuit.pbs_count, len(circuit.levels),
    )
    return result


def decrypt_count(client_key: ClientKey, ct_count: np.ndarray) -> int:
    """Decrypt ``count_matches``' little-endian base-4 digit rows."""
    total = 0
    for i in range(ct_count.shape[0]):
        total += decrypt(client_key, ct_count[i]) * (4 ** i)
    return total


def decrypt(client_key: ClientKey, ct_res: np.ndarray) -> int:
    """Radix decrypt of the match result (mod.rs:17)."""
    return _lwe.decrypt_byte(client_key.params, client_key.lwe_key, ct_res)
