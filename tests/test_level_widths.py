"""Two-shape level-width scheme ({SMALL_LEVEL_BATCH, MAX_LEVEL_BATCH}, used
when the minimum bucket is SMALL_LEVEL_BATCH) compiles and still decrypts
correctly."""

import numpy as np

from fhe_regex_tpu import decrypt, trivial_encrypt_str
from fhe_regex_tpu.params import TEST_PARAMS
from fhe_regex_tpu.regex.engine import compile_match
from fhe_regex_tpu.regex.executor import (MAX_LEVEL_BATCH, SMALL_LEVEL_BATCH,
                                          WIDE_LEVEL_BATCH, Executor,
                                          _chunk_sizes, compile_circuit)
from fhe_regex_tpu.ops.pbs import prepare_server_key


def test_two_shape_widths_and_correctness(keys):
    ck, sk = keys
    P = TEST_PARAMS
    content = "xxxxxabcxxxxxxxx"
    builder, root = compile_match(len(content), "/abc/", P.num_blocks,
                                  fold="tree")
    circuit = compile_circuit(P, builder, root,
                              min_bucket=SMALL_LEVEL_BATCH)
    widths = {lv.lut_idx.shape[0] for lv in circuit.levels}
    assert widths <= {SMALL_LEVEL_BATCH, MAX_LEVEL_BATCH}, widths

    ex = Executor(P, prepare_server_key(P, sk, "jnp"))
    ct = trivial_encrypt_str(P, content)
    res = ex.run(circuit, np.ascontiguousarray(ct))
    assert decrypt(ck, res) == 1

    ct2 = trivial_encrypt_str(P, "xxxxxaqcxxxxxxxx")
    assert decrypt(ck, ex.run(circuit, np.ascontiguousarray(ct2))) == 0


def test_wide_level_chunks_to_max_batch(keys):
    """A level wider than MAX_LEVEL_BATCH splits into max-width chunks plus
    a bucketed tail."""
    ck, sk = keys
    P = TEST_PARAMS
    content = "ab" * 24                     # many start positions
    builder, root = compile_match(len(content), "/ab/", P.num_blocks,
                                  fold="tree")
    circuit = compile_circuit(P, builder, root,
                              min_bucket=SMALL_LEVEL_BATCH)
    for lv in circuit.levels:
        assert lv.lut_idx.shape[0] in (SMALL_LEVEL_BATCH, MAX_LEVEL_BATCH)
    ex = Executor(P, prepare_server_key(P, sk, "jnp"))
    ct = trivial_encrypt_str(P, content)
    assert decrypt(ck, ex.run(circuit, np.ascontiguousarray(ct))) == 1


def test_chunk_sizes_shapes():
    """run_many launch plans only ever use the three executable shapes and
    cover the packed total; a padded wide launch replaces >3 narrow ones."""
    for total in (1, 64, 65, 256, 257, 768, 769, 1024, 1025, 2500, 5000):
        for wide in (False, True):
            sizes = _chunk_sizes(total, wide)
            allowed = {SMALL_LEVEL_BATCH, MAX_LEVEL_BATCH} | (
                {WIDE_LEVEL_BATCH} if wide else set())
            assert set(sizes) <= allowed, (total, wide, sizes)
            assert sum(sizes) >= total, (total, wide, sizes)
            # padding is bounded by one shape's worth
            assert sum(sizes) - total < max(sizes), (total, wide, sizes)
    assert _chunk_sizes(769, True) == [WIDE_LEVEL_BATCH]
    assert _chunk_sizes(768, True) == [MAX_LEVEL_BATCH] * 3
    assert _chunk_sizes(WIDE_LEVEL_BATCH + 65, True) == [
        WIDE_LEVEL_BATCH, MAX_LEVEL_BATCH]
    assert _chunk_sizes(40, True) == [SMALL_LEVEL_BATCH]


def test_run_many_wide_batch_correctness(keys):
    """run_many with the wide launch shape enabled decrypts identically to
    the narrow-only plan (packed level totals here exceed 768, so wide
    chunks are actually exercised)."""
    ck, sk = keys
    P = TEST_PARAMS
    content_hit = "ab" * 24
    content_miss = "ax" * 24
    builder, root = compile_match(len(content_hit), "/ab/", P.num_blocks,
                                  fold="tree")
    circuit = compile_circuit(P, builder, root,
                              min_bucket=SMALL_LEVEL_BATCH)
    ex = Executor(P, prepare_server_key(P, sk, "jnp"))
    cts = np.stack([trivial_encrypt_str(P, content_hit if i % 2 == 0
                                        else content_miss)
                    for i in range(8)])
    res_wide = ex.run_many(circuit, cts, wide_batch=True)
    res_narrow = ex.run_many(circuit, cts, wide_batch=False)
    got_w = [decrypt(ck, res_wide[i]) for i in range(8)]
    got_n = [decrypt(ck, res_narrow[i]) for i in range(8)]
    want = [1 if i % 2 == 0 else 0 for i in range(8)]
    assert got_w == want and got_n == want
