"""Kernel-level tests: distance scan, top-k merge, Hamming packing/scan.

Oracle is always float64 numpy over the same data (the reference tests its
kernels the same way: algorithm-level checks, SURVEY.md §4.1).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from grape_vector_db_tpu.ops import (
    scored_topk,
    merge_topk,
    pack_bits,
    hamming_scores,
    hamming_topk,
    words_per_vector,
)


def np_cosine(q, v):
    qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    vn = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    return qn @ vn.T


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_scored_topk_matches_numpy(rng, metric):
    n, d, b, k = 512, 64, 4, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[100:120] = False

    vals, idxs = scored_topk(
        jnp.asarray(qs), jnp.asarray(vecs), jnp.asarray(np.linalg.norm(vecs, axis=1)),
        jnp.asarray(valid), k=k, metric=metric, chunk=128,
    )
    vals, idxs = np.asarray(vals), np.asarray(idxs)

    if metric == "cosine":
        ref = np_cosine(qs, vecs)
    elif metric == "dot":
        ref = qs @ vecs.T
    else:
        ref = -((qs[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    ref = np.where(valid[None, :], ref, -np.inf)
    ref_idx = np.argsort(-ref, axis=1)[:, :k]

    for row in range(b):
        assert set(idxs[row]) == set(ref_idx[row])
        np.testing.assert_allclose(
            vals[row], np.sort(ref[row])[::-1][:k], rtol=2e-3, atol=2e-3
        )
        # descending order
        assert all(vals[row][i] >= vals[row][i + 1] - 1e-6 for i in range(k - 1))


def test_scored_topk_fewer_valid_than_k(rng):
    n, d = 128, 32
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.zeros(n, dtype=bool)
    valid[:3] = True
    vals, idxs = scored_topk(
        jnp.asarray(rng.standard_normal((1, d)).astype(np.float32)),
        jnp.asarray(vecs), jnp.asarray(np.linalg.norm(vecs, axis=1)),
        jnp.asarray(valid), k=10, metric="cosine", chunk=128,
    )
    vals = np.asarray(vals)[0]
    assert np.isfinite(vals[:3]).all()
    assert (vals[3:] == -np.inf).all()


def test_merge_topk(rng):
    va = np.array([[3.0, 1.0]]); ia = np.array([[7, 9]])
    vb = np.array([[2.5, 0.5]]); ib = np.array([[100, 101]])
    v, i = merge_topk(jnp.asarray(va), jnp.asarray(ia), jnp.asarray(vb), jnp.asarray(ib), k=3)
    np.testing.assert_allclose(np.asarray(v)[0], [3.0, 2.5, 1.0])
    np.testing.assert_array_equal(np.asarray(i)[0], [7, 100, 9])


def test_pack_bits_roundtrip(rng):
    for d in (32, 64, 100, 768):
        x = rng.standard_normal((5, d)).astype(np.float32)
        codes = np.asarray(pack_bits(jnp.asarray(x), 0.0))
        assert codes.shape == (5, words_per_vector(d))
        bits = (x > 0).astype(np.uint64)
        # unpack and compare
        unpacked = np.zeros((5, words_per_vector(d) * 32), dtype=np.uint64)
        for w in range(codes.shape[1]):
            for j in range(32):
                unpacked[:, w * 32 + j] = (codes[:, w] >> j) & 1
        np.testing.assert_array_equal(unpacked[:, :d], bits)
        assert (unpacked[:, d:] == 0).all()


def test_hamming_scores_matches_numpy(rng):
    d = 96
    a = rng.standard_normal((3, d)).astype(np.float32)
    b = rng.standard_normal((17, d)).astype(np.float32)
    ca, cb = pack_bits(jnp.asarray(a), 0.0), pack_bits(jnp.asarray(b), 0.0)
    got = np.asarray(hamming_scores(ca, cb))
    ba, bb = (a > 0), (b > 0)
    ref = (ba[:, None, :] != bb[None, :, :]).sum(-1)
    np.testing.assert_array_equal(got, ref)


def test_hamming_topk(rng):
    n, d, k = 256, 64, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[:2] + 0.01 * rng.standard_normal((2, d)).astype(np.float32)
    codes = pack_bits(jnp.asarray(x), 0.0)
    qcodes = pack_bits(jnp.asarray(q), 0.0)
    valid = np.ones(n, dtype=bool)
    dists, idxs = hamming_topk(qcodes, codes, jnp.asarray(valid), k=k, chunk=64)
    dists, idxs = np.asarray(dists), np.asarray(idxs)
    # nearest neighbor of a barely-perturbed vector is itself
    assert idxs[0, 0] == 0 and idxs[1, 0] == 1
    # ascending distances
    assert (np.diff(dists, axis=1) >= 0).all()


def test_verified_exact_topk_adversarial(rng):
    """The verified-exact path must stay exact on near-tie data (where
    approx_max_k alone would drop entries)."""
    import jax
    from grape_vector_db_tpu.ops.distance import _verified_exact_topk

    b, n, k = 8, 4096, 10
    # adversarial: many values within float eps of each other near the top
    base = np.ones((b, n), dtype=np.float32)
    scores = base + 1e-6 * rng.standard_normal((b, n)).astype(np.float32)
    # plant clear winners
    for row in range(b):
        scores[row, rng.integers(0, n, 3)] += 0.5
    vals, idxs = _verified_exact_topk(jnp.asarray(scores), k)
    vals, idxs = np.asarray(vals), np.asarray(idxs)
    ref = np.sort(scores, axis=1)[:, ::-1][:, :k]
    np.testing.assert_allclose(vals, ref, rtol=0, atol=0)  # bitwise-exact values
    # indices actually point at those values
    np.testing.assert_allclose(
        np.take_along_axis(scores, idxs, axis=1), vals, rtol=0, atol=0
    )


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_segmax_exact_topk_matches_oracle(rng, metric):
    """Two-phase segment-max engine is exact (values match a float64 oracle
    set-wise, invalid rows excluded)."""
    from grape_vector_db_tpu.ops.distance import (_segmax_exact_topk,
                                                  prepare_queries)

    n, d, b, k = 4096, 32, 4, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[50:80] = False
    q = prepare_queries(jnp.asarray(qs), metric)
    vals, idxs = _segmax_exact_topk(
        q, jnp.asarray(vecs), jnp.asarray(np.linalg.norm(vecs, axis=1)),
        jnp.asarray(valid), k, metric, chunk=1024,
    )
    vals, idxs = np.asarray(vals), np.asarray(idxs)

    if metric == "cosine":
        ref = np_cosine(qs, vecs)
    elif metric == "dot":
        ref = qs @ vecs.T
    else:
        ref = -((qs[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    ref = np.where(valid[None, :], ref, -np.inf)
    for row in range(b):
        expect = set(np.argsort(-ref[row])[:k])
        assert set(idxs[row]) == expect
        np.testing.assert_allclose(
            vals[row], np.sort(ref[row])[::-1][:k], rtol=2e-3, atol=2e-3)


def test_segmax_exact_topk_with_duplicate_segment_values(rng):
    """All top-k values packed into ONE segment (worst case for the proof:
    top-k segments must still cover them)."""
    from grape_vector_db_tpu.ops.distance import (_segmax_exact_topk,
                                                  prepare_queries)

    n, d, k = 1024, 16, 8
    vecs = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    target = rng.standard_normal(d).astype(np.float32)
    # rows 64..71 (one segment) are all near-duplicates of the query
    for j in range(8):
        vecs[64 + j] = target * (1.0 + 1e-4 * j)
    q = prepare_queries(jnp.asarray(target[None, :]), "cosine")
    vals, idxs = _segmax_exact_topk(
        q, jnp.asarray(vecs), jnp.asarray(np.linalg.norm(vecs, axis=1)),
        jnp.asarray(np.ones(n, bool)), k, "cosine", chunk=512,
    )
    assert set(np.asarray(idxs)[0]) == set(range(64, 72))


def test_scored_topk_large_corpus_segmax_route(rng):
    """scored_topk routes big exact scans through the segmax engine and
    stays exact."""
    n, d, b, k = 327_680, 16, 2, 5
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    qs = vecs[:b] + 0.001 * rng.standard_normal((b, d)).astype(np.float32)
    vals, idxs = scored_topk(
        jnp.asarray(qs), jnp.asarray(vecs),
        jnp.asarray(np.linalg.norm(vecs, axis=1)),
        jnp.asarray(np.ones(n, bool)), k=k, metric="cosine",
    )
    idxs = np.asarray(idxs)
    assert idxs[0, 0] == 0 and idxs[1, 0] == 1
    assert np.asarray(vals)[0, 0] > 0.999


def test_hamming_mxu_matches_popcount(rng):
    """The sign-bit matmul form (default) must be bit-for-bit equal to
    the XOR+popcount form — dot(s_q, s_x) = D - 2*hamming is exact integer
    algebra, including the zero pad bits both sides share."""
    a = rng.standard_normal((16, 100)).astype(np.float32)  # non-multiple of 32
    b = rng.standard_normal((640, 100)).astype(np.float32)
    ca, cb = pack_bits(jnp.asarray(a)), pack_bits(jnp.asarray(b))
    ref = np.asarray(hamming_scores(ca, cb, impl="xla"))
    got = np.asarray(hamming_scores(ca, cb, impl="mxu"))
    np.testing.assert_array_equal(got, ref)


def test_segmax_pallas_matches_exact(rng, interpret_kernels):
    """The fused matmul + segment-max kernel (interpreted) returns the exact
    top-k — same values as scored_topk's exact engines, masked included."""
    from grape_vector_db_tpu.ops.segmax_pallas import segmax_topk
    from grape_vector_db_tpu.ops.distance import scored_topk

    n, d, b, k = 8192, 128, 16, 10
    vecs = jnp.asarray(rng.standard_normal((n, d)), jnp.bfloat16)
    norms = jnp.linalg.norm(vecs.astype(jnp.float32), axis=1)
    valid = jnp.asarray(rng.random(n) > 0.1)
    q = jnp.asarray(rng.standard_normal((b, d)), jnp.float32)
    for metric in ("cosine", "dot"):
        for kk in (1, 10, 33):
            rv, _ = scored_topk(q, vecs, norms, valid, k=kk, metric=metric,
                                chunk=n, mode="exact")
            pv, _ = segmax_topk(q, vecs, norms, valid, k=kk, metric=metric)
            np.testing.assert_allclose(np.asarray(pv), np.asarray(rv),
                                       rtol=1e-5, atol=1e-5)
    mask = jnp.asarray(rng.random(n) > 0.7)
    rv, _ = scored_topk(q, vecs, norms, valid, k=k, metric="cosine",
                        chunk=n, mode="exact", mask=mask)
    pv, _ = segmax_topk(q, vecs, norms, valid, k=k, metric="cosine",
                        mask=mask)
    np.testing.assert_allclose(np.asarray(pv), np.asarray(rv),
                               rtol=1e-5, atol=1e-5)


def test_segmax_pallas_many_topk_rows_in_one_segment(rng, interpret_kernels):
    """Adversarial placement: 12 near-duplicates of one strong row share ONE
    strided segment, so most of the true top-10 hide behind a single
    segment maximum — the phase-2 rescore of that segment's rows must
    surface all of them, with their own row ids."""
    from grape_vector_db_tpu.ops.segmax_pallas import CB, SUB, segmax_topk
    from grape_vector_db_tpu.ops.distance import scored_topk

    n, d, b = 8192, 128, 4
    v = rng.standard_normal((n, d)).astype(np.float32)
    members = [CB + 5 + m * SUB for m in range(12)]   # block 1, column 5
    for m, row in enumerate(members):
        v[row] = v[77] * (4.0 + 1e-2 * m)
    vecs = jnp.asarray(v, jnp.bfloat16)
    norms = jnp.linalg.norm(vecs.astype(jnp.float32), axis=1)
    valid = jnp.ones(n, bool)
    q = jnp.asarray(v[77:78] + 0.01 * rng.standard_normal((b, d)),
                    jnp.float32)
    rv, ri = scored_topk(q, vecs, norms, valid, k=10, metric="dot", chunk=n,
                         mode="exact")
    pv, pi = segmax_topk(q, vecs, norms, valid, k=10, metric="dot")
    np.testing.assert_allclose(np.asarray(pv), np.asarray(rv),
                               rtol=1e-5, atol=1e-5)
    for row in np.asarray(pi):
        assert len(set(row.tolist())) == len(row)
        assert len(set(row.tolist()) & set(members)) >= 9


def test_segmax_pallas_exact_ties_return_distinct_rows(rng, interpret_kernels):
    """EXACT intra-segment score ties (duplicate vectors — common in real
    corpora): the rescore must return every tied row as a DISTINCT row id,
    not the same id repeated (which would silently drop the other rows)."""
    from grape_vector_db_tpu.ops.segmax_pallas import SUB, segmax_topk
    from grape_vector_db_tpu.ops.distance import scored_topk

    n, d, b = 8192, 128, 4
    vecs = np.asarray(rng.standard_normal((n, d)), np.float32)
    # queries share a common direction and the tied vector is a strong
    # multiple of it, so the tied rows are the global top scores for EVERY
    # query (plain random dot products can be negative)
    base = rng.standard_normal(d).astype(np.float32)
    q_np = (base[None, :] + 0.1 * rng.standard_normal((b, d))).astype(
        np.float32)
    # three IDENTICAL copies inside one strided segment (block 0, column 17)
    tied_rows = [17 + m * SUB for m in (2, 6, 11)]
    for r in tied_rows:
        vecs[r] = base * 10.0
    vecs = jnp.asarray(vecs, jnp.bfloat16)
    norms = jnp.linalg.norm(vecs.astype(jnp.float32), axis=1)
    valid = jnp.ones(n, bool)
    q = jnp.asarray(q_np)
    for k in (3, 4, 10):
        rv, _ = scored_topk(q, vecs, norms, valid, k=k, metric="dot",
                            chunk=n, mode="exact")
        pv, pi = segmax_topk(q, vecs, norms, valid, k=k, metric="dot")
        np.testing.assert_allclose(np.asarray(pv), np.asarray(rv),
                                   rtol=1e-5, atol=1e-5)
        for row in np.asarray(pi):
            assert len(set(row.tolist())) == len(row), (k, row)
            assert set(tied_rows) <= set(row.tolist()), (k, row)


def test_segmax_engines_degenerate_validity_no_duplicate_ids(
        rng, interpret_kernels):
    """Large-capacity bucket holding FEW valid docs, concentrated in 3 fully
    valid strided segments (96 rows, fewer finite segments than picks): the
    iterative selection's tail repeatedly picks segment 0 (argmax over an
    all--inf plane), and without the degenerate-plane guard the repeated
    rescore emits the same row ids multiple times, displacing true rows."""
    from grape_vector_db_tpu.ops.segmax_pallas import SUB, segmax_topk

    n, d, b, k = 8192, 128, 4, 10
    vecs = jnp.asarray(rng.standard_normal((n, d)), jnp.bfloat16)
    norms = jnp.linalg.norm(vecs.astype(jnp.float32), axis=1)
    # all 32 members of strided segments 0/1/2 in block 0: rows j + m*SUB
    valid_np = np.zeros(n, bool)
    valid_rows = np.array([j + m * SUB for j in (0, 1, 2) for m in range(32)])
    valid_np[valid_rows] = True
    valid = jnp.asarray(valid_np)
    q = jnp.asarray(rng.standard_normal((b, d)), jnp.float32)
    qb = np.asarray(q.astype(jnp.bfloat16), np.float64)
    sc = qb @ np.asarray(vecs, np.float64)[valid_rows].T      # [B, 96]
    oracle_v = -np.sort(-sc, axis=1)[:, :k]
    pv, pi = segmax_topk(q, vecs, norms, valid, k=k, metric="dot")
    pv, pi = np.asarray(pv), np.asarray(pi)
    np.testing.assert_allclose(pv, oracle_v, rtol=1e-4, atol=1e-4)
    for row_i in pi:
        assert len(set(row_i.tolist())) == len(row_i), row_i
        assert set(row_i.tolist()) <= set(valid_rows.tolist()), row_i


def test_twolevel_topk_matches_topk(rng):
    """_twolevel_topk (supersegment pre-selection) must return the exact
    top-k values over the minor axis — both above and below its ns >= kk
    routing guard, and with -inf (masked) columns present."""
    import jax

    from grape_vector_db_tpu.ops.segmax_pallas import _twolevel_topk

    for b, w, kk in ((4, 2048, 10), (3, 4096, 64), (2, 512, 32)):
        plane = rng.standard_normal((b, w)).astype(np.float32)
        plane[:, rng.integers(0, w, size=w // 8)] = -np.inf
        ref_v, _ = jax.lax.top_k(jnp.asarray(plane), kk)
        got_v, got_i = _twolevel_topk(jnp.asarray(plane), kk)
        np.testing.assert_allclose(np.asarray(got_v), np.asarray(ref_v),
                                   rtol=1e-6, atol=1e-6)
        # returned indices must point at the returned values
        picked = np.take_along_axis(plane, np.asarray(got_i), axis=1)
        np.testing.assert_allclose(picked, np.asarray(got_v),
                                   rtol=1e-6, atol=1e-6)


def test_twolevel_topk_degenerate_sparse_plane(rng):
    """Fewer finite supersegments than k: the -inf tail of the supersegment
    selection repeats block 0, and without first-occurrence masking the
    duplicated children displace true top-k rows (review-confirmed bug)."""
    import jax

    from grape_vector_db_tpu.ops.segmax_pallas import _twolevel_topk

    b, w, kk, fan = (3, 4096, 10, 128)
    plane = np.full((b, w), -np.inf, dtype=np.float32)
    # finite values confined to 2 supersegments (blocks 3 and 17)
    for blk in (3, 17):
        plane[:, blk * fan:(blk + 1) * fan] = rng.standard_normal(
            (b, fan)).astype(np.float32)
    ref_v, _ = jax.lax.top_k(jnp.asarray(plane), kk)
    got_v, got_i = _twolevel_topk(jnp.asarray(plane), kk, fan=fan)
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(ref_v),
                               rtol=1e-6, atol=1e-6)
    # the finite results must be distinct columns (no duplicated rows)
    gi = np.asarray(got_i)
    gv = np.asarray(got_v)
    for row in range(b):
        finite = gi[row][np.isfinite(gv[row])]
        assert len(set(finite.tolist())) == len(finite)


def test_fetch_scores_slots_roundtrip(rng):
    """The packed single-transfer fetch must round-trip every int32 bit
    pattern (slot ids that alias NaN/Inf f32 lanes included) and preserve
    scores exactly."""
    import jax.numpy as jnp

    from grape_vector_db_tpu.utils.fetch import fetch_scores_slots

    vals = rng.standard_normal((5, 7)).astype(np.float32)
    vals[0, 0] = -np.inf
    vals[1, 2] = np.inf
    idxs = rng.integers(-(2**31), 2**31 - 1, size=(5, 7), dtype=np.int32)
    idxs[2, 3] = 0x7FC00000 - 2**32 // 2  # NaN-pattern-adjacent
    idxs[3, 1] = -1
    idxs[4, 0] = 2**31 - 1
    # real slot ids are SMALL ints: as f32 bit patterns those are denormals,
    # which a device may flush to zero — the pack must therefore carry them
    # in integer lanes. The CPU does not flush; keep the values anyway so
    # the intent is pinned.
    idxs[0, :5] = np.arange(5, dtype=np.int32)
    vals[2, 4] = 1e-40  # denormal score must survive the int32 bitcast too
    out_v, out_i = fetch_scores_slots(jnp.asarray(vals), jnp.asarray(idxs))
    np.testing.assert_array_equal(out_v, vals)
    np.testing.assert_array_equal(out_i, idxs)
    assert out_i.dtype == np.int32
