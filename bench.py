"""Per-engine query-throughput matrix on one NVIDIA GPU.

    python bench.py            # BENCH_SCALE=N divides the corpus sizes

Workloads (BASELINE.md configs): 100k x 768-d bf16 corpus, batched top-10
queries, one engine per row — flat exact / flat approx / int8 two-stage /
binary two-stage / IVF — plus 1M x 768 points for the engines that matter at
that scale (flat approx, int8, segment-max exact, the IVF kinds). The
reference's read-path number is 42,018 QPS on CPU
(docs/project-status-summary.md:21); ``vs_baseline`` is exact-flat
queries/sec over that.

Timing: device rows run ITERS iterations inside one jitted ``lax.fori_loop``
with a loop-carried data dependence (XLA cannot elide iterations); one host
readback closes the measurement; corpus arrays are passed as jit operands
(closure capture would bake them into the executable). IVF rows time the
index's own ``search_batch``. Refuses to run without a GPU.

Prints two JSON lines: the full matrix, then a compact summary.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_READ_QPS = 42_018.0
DIM, K, BATCH = 768, 10, 128
# CPU smoke mode: divide corpus sizes (BENCH_SCALE=16 for the test suite)
SCALE = int(os.environ.get("BENCH_SCALE", "1"))


def main() -> int:
    import jax
    import jax.numpy as jnp
    from jax import lax, random

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs an NVIDIA GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2

    from grape_vector_db_tpu.index import FlatDeviceIndex
    from grape_vector_db_tpu.ops.distance import scored_topk
    from grape_vector_db_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    n, cap = 100_000 // SCALE, 131_072 // SCALE
    iters = 60 if SCALE == 1 else 4
    rng = np.random.default_rng(0)
    matrix: dict = {}

    # ---------------------------------------------------------------- helpers

    def timed_fori_reps(step_fn, q0, *operands, its: int = iters,
                        reps: int = 3):
        """(best_ms, median_ms) per iteration over ``reps`` timed loop
        executions: the matrix records both the best draw and the median."""
        @jax.jit
        def loop(q, *ops):
            def body(i, acc):
                qq = q * (1.0 + acc * 1e-9)
                vals, _ = step_fn(qq, *ops)
                return acc * 0.5 + vals[0, 0] * 1e-6
            return lax.fori_loop(0, its, body, jnp.float32(0))

        float(np.asarray(loop(q0, *operands)))  # compile + warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(np.asarray(loop(q0, *operands)))
            times.append(time.perf_counter() - t0)
        times.sort()
        to_ms = lambda t: t * 1e3 / its
        return to_ms(times[0]), to_ms(times[len(times) // 2])

    def timed_fori(step_fn, q0, *operands, its: int = iters) -> float:
        return timed_fori_reps(step_fn, q0, *operands, its=its)[0]

    def timed_search(index, q, reps: int = 20) -> tuple:
        """(best_ms, median_ms) of index.search_batch over reps calls."""
        index.search_batch(q, K)  # compile + warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            index.search_batch(q, K)
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        return times[0], times[len(times) // 2]

    def recall_vs(oracle_ids, hits_rows) -> float:
        got = 0
        for want, row in zip(oracle_ids, hits_rows):
            ids = {h[0] for h in row}
            got += sum(1 for w in want if f"doc-{w}" in ids)
        return got / oracle_ids.size

    # ---------------------------------------------------------------- corpus

    idx = FlatDeviceIndex(dimension=DIM, metric="cosine",
                          storage_dtype="bfloat16", initial_capacity=cap)
    ids = [f"doc-{i}" for i in range(n)]
    vecs = rng.standard_normal((n, DIM), dtype=np.float32)
    for i in range(0, n, 8192):
        idx.add_batch(ids[i:i + 8192], vecs[i:i + 8192])

    queries = rng.standard_normal((BATCH, DIM), dtype=np.float32)
    q_dev = jnp.asarray(queries)

    # numpy oracle for recall columns (4 queries is enough for a sanity recall)
    qn = queries[:8] / np.linalg.norm(queries[:8], axis=1, keepdims=True)
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    oracle = np.argsort(-(qn @ vn.T), axis=1)[:, :K]

    # ---------------------------------------------------------------- ingest

    ibs = min(8192, n)
    nb = n // ibs
    stage_vecs = jnp.asarray(vecs[: nb * ibs].reshape(nb, ibs, DIM))
    stage_norms = jnp.linalg.norm(stage_vecs, axis=2)
    stage_slots = jnp.arange(nb * ibs, dtype=jnp.int32).reshape(nb, ibs)

    @jax.jit
    def ingest_loop(vectors, norms, valid, sv, sn, ss):
        def step(i, carry):
            vectors, norms, valid = carry
            vectors = vectors.at[ss[i]].set(sv[i].astype(vectors.dtype))
            norms = norms.at[ss[i]].set(sn[i])
            valid = valid.at[ss[i]].set(True)
            return (vectors, norms, valid)
        return lax.fori_loop(0, nb, step, (vectors, norms, valid))

    out = ingest_loop(idx.vectors, idx.norms, idx.valid, stage_vecs,
                      stage_norms, stage_slots)
    float(np.asarray(out[1][0]))  # compile + force
    t0 = time.perf_counter()
    out = ingest_loop(idx.vectors, idx.norms, idx.valid, stage_vecs,
                      stage_norms, stage_slots)
    float(np.asarray(out[1][0]))
    ingest_s = time.perf_counter() - t0
    matrix["ingest_100k"] = {
        "docs_per_s": round(nb * ibs / ingest_s, 0),
    }
    del stage_vecs, stage_norms, stage_slots, out

    # ------------------------------------------------- write path (full API)
    # End-to-end batch_add_documents: store + vector-index scatter + BM25
    # inverted index + filter columns (the reference's 13,240 write QPS was
    # its storage layer alone). Steady-state protocol: first batch warms jit
    # caches, GC paused, device queue drained inside the timed region.
    if SCALE == 1:
        import gc

        from grape_vector_db_tpu import Document, VectorDatabase
        from grape_vector_db_tpu.config import VectorDbConfig

        wcfg = VectorDbConfig(vector_dimension=DIM)
        wcfg.index.initial_capacity = cap
        wcfg.cache.enabled = False
        wdocs = [Document(id=f"w{i}", content=f"doc {i} topic{i % 7}",
                          vector=vecs[i]) for i in range(n)]
        wb = 4096

        def write_draw() -> float:
            wdb = VectorDatabase(config=wcfg)
            wdb.batch_add_documents(wdocs[:wb])  # warm jit caches
            gc.collect()
            gc.disable()
            try:
                t0 = time.perf_counter()
                for i in range(wb, n, wb):
                    wdb.batch_add_documents(wdocs[i:i + wb])
                jax.block_until_ready(getattr(wdb.index, "vectors", None))
                dt = time.perf_counter() - t0
            finally:
                gc.enable()
            wdb.close()
            return (n - wb) / dt

        # host-side work varies run to run: take >= 2 draws, report best +
        # median, score the median
        wdraws = [write_draw()]
        wdraws.append(write_draw())
        if (n - wb) / wdraws[0] < 30.0:  # first draw fast -> afford a third
            wdraws.append(write_draw())
        w_med = float(np.median(wdraws))
        matrix["write_path_100k"] = {
            "docs_per_s": round(max(wdraws), 0),
            "docs_per_s_median": round(w_med, 0),
            "draws": [round(d, 0) for d in wdraws],
            "vs_write_baseline_13240": round(w_med / 13_240, 2),
            "note": "full batch_add_documents (store+index+BM25+filters); "
                    "best + median over draws (embeddings ship as bf16 to "
                    "halve the bytes)",
        }
        del wdocs

    # ------------------------------------------------------------- flat modes

    def step_flat(q, vectors, norms, valid, mode):
        return scored_topk(q, vectors, norms, valid, k=K, metric="cosine",
                           mode=mode)

    for mode in ("exact", "approx"):
        def stepper(q, vectors, norms, valid, mode=mode):
            return step_flat(q, vectors, norms, valid, mode)
        ms = timed_fori(stepper, q_dev, idx.vectors, idx.norms, idx.valid)
        hits = idx.search_batch(queries[:8], K) if mode == "exact" else None
        row = {"batch_ms": round(ms, 3), "qps": round(BATCH / ms * 1e3, 0)}
        if mode == "exact":
            row["recall"] = round(recall_vs(oracle, hits), 3)
        matrix[f"flat_{mode}_100k"] = row
    # fail fast: a corrupted result (e.g. a packed fetch whose slot ids a
    # device flushed as denormals) should stop the run before the 1M rows
    assert matrix["flat_exact_100k"]["recall"] >= 0.9, \
        f"flat exact recall corrupted: {matrix['flat_exact_100k']}"
    exact_qps = matrix["flat_exact_100k"]["qps"]

    # --------------------------------------------------------------- int8

    from grape_vector_db_tpu.index.int8 import Int8DeviceIndex
    from grape_vector_db_tpu.ops.int8 import int8_topk

    i8 = Int8DeviceIndex(dimension=DIM, metric="cosine",
                         storage_dtype="bfloat16", initial_capacity=cap)
    for i in range(0, n, 8192):
        i8.add_batch(ids[i:i + 8192], vecs[i:i + 8192])

    from grape_vector_db_tpu.index.binary import _rescore_topk

    r8 = i8._rescore_count(K)

    def step_int8(q, codes, factor, valid, vectors, norms):
        cvals, cand = int8_topk(q, codes, factor, valid, k=r8, chunk=cap)
        dist = jnp.where(jnp.isfinite(cvals), 0, 2**30).astype(jnp.int32)
        return _rescore_topk(q, vectors, norms, cand, dist, k=K,
                             metric="cosine")

    factor8 = i8.scales / jnp.maximum(i8.norms, 1e-12)
    ms = timed_fori(step_int8, q_dev, i8.codes, factor8, i8.valid,
                    i8.vectors, i8.norms)
    matrix["int8_100k"] = {
        "batch_ms": round(ms, 3), "qps": round(BATCH / ms * 1e3, 0),
        "recall": round(recall_vs(oracle, i8.search_batch(queries[:8], K)), 3),
    }
    del i8, factor8

    # --------------------------------------------------------------- binary

    from grape_vector_db_tpu.index.binary import BinaryDeviceIndex
    from grape_vector_db_tpu.ops.hamming import asym_topk

    # The pre-scan is the sign-bit matmul; what remains is the selection +
    # rescore gather, which scale with the rescore budget. On random data
    # Hamming ranking correlates weakly with cosine, so two-stage BQ needs a
    # large budget; BQ's real role is the 32x capacity config
    # (keep_vectors=False). This row records the engine at rescore=1024.
    bq = BinaryDeviceIndex(dimension=DIM, metric="cosine",
                           storage_dtype="bfloat16", initial_capacity=cap,
                           max_rescore=1024)
    for i in range(0, n, 8192):
        bq.add_batch(ids[i:i + 8192], vecs[i:i + 8192])
    rb = bq._rescore_count(K)

    def step_bin(q, codes, valid, vectors, norms):
        # Prescan is the product default: asymmetric dot(q_unit, sign(x)),
        # the same matmul as Hamming with the real-valued query.
        pv, cand = asym_topk(q.astype(jnp.float32), codes, valid, k=rb,
                             chunk=cap)
        dists = jnp.where(jnp.isfinite(pv), 0, 1 << 30).astype(jnp.int32)
        return _rescore_topk(q, vectors, norms, cand, dists, k=K,
                             metric="cosine")

    ms = timed_fori(step_bin, q_dev, bq.codes, bq.valid, bq.vectors, bq.norms)
    matrix["binary_100k"] = {
        "batch_ms": round(ms, 3), "qps": round(BATCH / ms * 1e3, 0),
        "recall": round(recall_vs(oracle, bq.search_batch(queries[:8], K)), 3),
        "note": "asym sign-bit prescan + rescore=1024; BQ is the 32x capacity play (see docs)",
    }
    del bq

    # ----------------------------------------------------------------- ivf

    from grape_vector_db_tpu.index.ivf import IvfDeviceIndex

    # Representative row: clustered corpus + corpus-drawn queries — the
    # regime IVF exists for. The random-data point stays
    # below as a separately-labeled adversarial row.
    ncent100 = max(2048 // SCALE, 4)
    centers100 = rng.standard_normal((ncent100, DIM)).astype(np.float32)
    cid100 = rng.integers(0, ncent100, n)
    cvecs = (centers100[cid100]
             + 0.25 * rng.standard_normal((n, DIM))).astype(np.float32)
    ivf_c = IvfDeviceIndex(dimension=DIM, metric="cosine",
                           storage_dtype="bfloat16", initial_capacity=cap,
                           nlist=256 // SCALE or 4, nprobe=16,
                           train_size=50_000 // SCALE)
    for i in range(0, n, 8192):
        ivf_c.add_batch(ids[i:i + 8192], cvecs[i:i + 8192])
    cq100 = (cvecs[:: n // BATCH][:BATCH]
             + 0.05 * rng.standard_normal((BATCH, DIM))).astype(np.float32)
    cqn = cq100[:8] / np.linalg.norm(cq100[:8], axis=1, keepdims=True)
    cvn = cvecs / np.linalg.norm(cvecs, axis=1, keepdims=True)
    oracle_c = np.argsort(-(cqn @ cvn.T), axis=1)[:, :K]
    del cvn
    ms, _ = timed_search(ivf_c, cq100)
    matrix["ivf_100k_nprobe16"] = {
        "batch_ms": round(ms, 3), "qps": round(BATCH / ms * 1e3, 0),
        "recall": round(recall_vs(oracle_c,
                                  ivf_c.search_batch(cq100[:8], K)), 3),
        "note": "clustered corpus, corpus-drawn queries (representative); "
                + ("probe kernel" if ivf_c._use_kernel else "XLA probe")
                + "; search_batch wall time",
    }
    # Binary on the same clustered corpus: the regime the two-stage engine
    # is built for (the random-data binary_100k row above is the
    # adversarial floor where Hamming correlates weakly with cosine).
    # Budget 64 is tune_rescore's pick at target 0.95 AND 0.99 on this
    # corpus (self-recall sweep vs the exact oracle, index/binary.py) — the
    # rescore gather is per-row bound, so the tuned budget gathers 16x
    # fewer rows than the adversarial row's 1024. Fixed (not
    # tuned in-bench) to keep the jit shapes stable run-to-run.
    bq_c = BinaryDeviceIndex(dimension=DIM, metric="cosine",
                             storage_dtype="bfloat16", initial_capacity=cap,
                             max_rescore=64)
    for i in range(0, n, 8192):
        bq_c.add_batch(ids[i:i + 8192], cvecs[i:i + 8192])
    rb_c = bq_c._rescore_count(K)

    def step_bin_c(q, codes, valid, vectors, norms):
        pv, cand = asym_topk(q.astype(jnp.float32), codes, valid, k=rb_c,
                             chunk=cap)
        dists = jnp.where(jnp.isfinite(pv), 0, 1 << 30).astype(jnp.int32)
        return _rescore_topk(q, vectors, norms, cand, dists, k=K,
                             metric="cosine")

    ms = timed_fori(step_bin_c, jnp.asarray(cq100), bq_c.codes, bq_c.valid,
                    bq_c.vectors, bq_c.norms)
    matrix["binary_100k_clustered"] = {
        "batch_ms": round(ms, 3), "qps": round(BATCH / ms * 1e3, 0),
        "recall": round(recall_vs(oracle_c,
                                  bq_c.search_batch(cq100[:8], K)), 3),
        "note": "representative regime (clustered, corpus-drawn queries); "
                "rescore budget 64 = tune_rescore's pick at target 0.99 "
                "(the adversarial binary_100k row needs 1024)",
    }
    del bq_c

    del ivf_c, cvecs

    ivf = IvfDeviceIndex(dimension=DIM, metric="cosine",
                         storage_dtype="bfloat16", initial_capacity=cap,
                         nlist=256 // SCALE or 4, nprobe=16,
                         train_size=50_000 // SCALE)
    for i in range(0, n, 8192):
        ivf.add_batch(ids[i:i + 8192], vecs[i:i + 8192])
    ms, _ = timed_search(ivf, queries)
    matrix["ivf_100k_random_adversarial"] = {
        "batch_ms": round(ms, 3), "qps": round(BATCH / ms * 1e3, 0),
        "recall": round(recall_vs(oracle, ivf.search_batch(queries[:8], K)), 3),
        "note": "random data is IVF's worst case (kept as the honest adversarial point)",
    }
    del ivf

    # ------------------------------------------------- 1M points (on-device)

    key = random.PRNGKey(1)
    chunk1m = 131_072 // SCALE
    parts_v, parts_n = [], []

    @jax.jit
    def gen(k1):
        x = random.normal(k1, (chunk1m, DIM), jnp.float32)
        return x.astype(jnp.bfloat16), jnp.linalg.norm(x, axis=1)

    for _ in range(8):
        k1, key = random.split(key)
        v, nn_ = gen(k1)
        parts_v.append(v)
        parts_n.append(nn_)
    v1m = jnp.concatenate(parts_v)
    n1m = jnp.concatenate(parts_n)
    m1m = jnp.ones((v1m.shape[0],), jnp.bool_)
    del parts_v, parts_n

    def step_1m_approx(q, vectors, norms, valid):
        return scored_topk(q, vectors, norms, valid, k=K, metric="cosine",
                           chunk=chunk1m, mode="approx")

    ms = timed_fori(step_1m_approx, q_dev, v1m, n1m, m1m, its=24 if SCALE == 1 else 2)
    matrix["flat_approx_1M"] = {"batch_ms": round(ms, 3),
                                "qps": round(BATCH / ms * 1e3, 0)}

    from grape_vector_db_tpu.ops.int8 import quantize_int8

    parts_i, parts_s = [], []
    for i in range(8):
        vi, sc = quantize_int8(lax.dynamic_slice_in_dim(v1m, i * chunk1m,
                                                        chunk1m))
        parts_i.append(vi)
        parts_s.append(sc)
    c1m = jnp.concatenate(parts_i)
    f1m = jnp.concatenate(parts_s) / jnp.maximum(n1m, 1e-12)
    del parts_i, parts_s

    def step_1m_int8(q, codes, factor, valid, vectors, norms):
        cvals, cand = int8_topk(q, codes, factor, valid, k=64, chunk=chunk1m)
        dist = jnp.where(jnp.isfinite(cvals), 0, 2**30).astype(jnp.int32)
        return _rescore_topk(q, vectors, norms, cand, dist, k=K,
                             metric="cosine")

    ms = timed_fori(step_1m_int8, q_dev, c1m, f1m, m1m, v1m, n1m, its=24 if SCALE == 1 else 2)
    matrix["int8_1M"] = {"batch_ms": round(ms, 3),
                         "qps": round(BATCH / ms * 1e3, 0)}

    # exact 1M: scored_topk routes to the fused segment-max kernel on a GPU
    # (ops/segmax_pallas.py), measured in-loop like every other row.
    def step_1m_exact(q, vectors, norms, valid):
        return scored_topk(q, vectors, norms, valid, k=K, metric="cosine",
                           chunk=chunk1m, mode="exact")

    ms, ms_med = timed_fori_reps(step_1m_exact, q_dev, v1m, n1m, m1m,
                                 its=32 if SCALE == 1 else 2, reps=5)
    matrix["flat_exact_1M"] = {
        "batch_ms": round(ms, 3), "qps": round(BATCH / ms * 1e3, 0),
        "batch_ms_median": round(ms_med, 3),
        "qps_median": round(BATCH / ms_med * 1e3, 0),
        "recall": 1.0,  # exact engine (segment-bound argument + parity tests)
        "note": "fused segment-max kernel, recall 1.0 by construction",
    }

    # Throughput batch for the same engine: the 1.6 GB corpus read dominates
    # and amortizes across the batch.
    q256_dev = jnp.concatenate([q_dev, q_dev * 1.0001 + 0.001])
    ms, ms_med = timed_fori_reps(step_1m_exact, q256_dev, v1m, n1m, m1m,
                                 its=16 if SCALE == 1 else 2, reps=5)
    matrix["flat_exact_1M_b256"] = {
        "batch_ms": round(ms, 3), "qps": round(256 / ms * 1e3, 0),
        "batch_ms_median": round(ms_med, 3),
        "qps_median": round(256 / ms_med * 1e3, 0),
        "note": "exact engine at the throughput batch (256 queries)",
    }
    del v1m, n1m, m1m, c1m, f1m

    # ------------------------------------------ IVF kinds @1M clustered
    # Each row builds the index through add_batch and times its own
    # search_batch (the path a user's query takes), nprobe = 1.

    from grape_vector_db_tpu.index.ivf_int4 import Int4IvfDeviceIndex
    from grape_vector_db_tpu.index.ivf_int8 import Int8IvfDeviceIndex

    n1m = 8 * chunk1m
    nlist = max(4096 // SCALE, 8)
    ncent = max(16_384 // SCALE, 4)
    kc, key = random.split(key)
    centers = random.normal(kc, (ncent, DIM), jnp.float32)

    @jax.jit
    def genc(k1, k2, cents):
        cid = random.randint(k2, (chunk1m,), 0, cents.shape[0])
        return cents[cid] + 0.25 * random.normal(k1, (chunk1m, DIM),
                                                 jnp.float32)

    parts = []
    for _ in range(8):
        k1, k2, key = random.split(key, 3)
        parts.append(np.asarray(genc(k1, k2, centers)))
    cv1m = np.concatenate(parts)
    del parts
    ids1m = [f"doc-{i}" for i in range(n1m)]
    kq2, key = random.split(key)
    qc = (cv1m[:: n1m // BATCH][:BATCH]
          + 0.05 * np.asarray(random.normal(kq2, (BATCH, DIM)))
          ).astype(np.float32)
    qcn = qc / np.linalg.norm(qc, axis=1, keepdims=True)
    oracle_1m = np.argsort(-(qcn @ (cv1m / np.linalg.norm(
        cv1m, axis=1, keepdims=True)).T), axis=1)[:, :K]

    rows_1m = {
        "ivf_1M_clustered_nprobe1": (IvfDeviceIndex, {}),
        "ivf_int8_1M_clustered_nprobe1": (Int8IvfDeviceIndex,
                                          {"keep_bf16": False}),
        "ivf_int4_1M_clustered_nprobe1": (Int4IvfDeviceIndex,
                                          {"keep_bf16": False}),
        "ivf_int4_rescore_1M_clustered_nprobe1": (Int4IvfDeviceIndex, {}),
    }
    for name, (cls, extra) in rows_1m.items():
        index = cls(DIM, metric="cosine", storage_dtype="bfloat16",
                    initial_capacity=2 * n1m, nlist=nlist, nprobe=1,
                    train_size=65_536 // SCALE, **extra)
        for i in range(0, n1m, 131_072 // SCALE):
            index.add_batch(ids1m[i:i + 131_072 // SCALE],
                            cv1m[i:i + 131_072 // SCALE])
        ms, ms_med = timed_search(index, qc)
        matrix[name] = {
            "batch_ms": round(ms, 3), "qps": round(BATCH / ms * 1e3, 0),
            "batch_ms_median": round(ms_med, 3),
            "qps_median": round(BATCH / ms_med * 1e3, 0),
            "recall": round(recall_vs(oracle_1m, index.search_batch(qc, K)),
                            4),
            "note": ("probe kernel" if index._use_kernel else "XLA probe")
                    + "; 16k-cluster corpus, corpus-drawn queries; "
                    "search_batch wall time, best + median of 20",
        }
        del index
    del cv1m

    # ------------------------------------------------------------ correctness

    hits = idx.search_batch(queries[:8], 100)
    for row, want in zip(hits, oracle):
        got_ids = {h[0] for h in row}
        overlap = sum(1 for w in want if f"doc-{w}" in got_ids)
        assert overlap >= int(0.9 * K), f"sanity recall too low: {overlap}/{K}"

    ns = matrix["ivf_1M_clustered_nprobe1"]
    ns8 = matrix["ivf_int8_1M_clustered_nprobe1"]
    result = {
        "metric": f"exact_cosine_top{K}_qps_{n // 1000}k_x_{DIM}d_bf16_batch{BATCH}",
        "value": exact_qps,
        "unit": "queries/s",
        "vs_baseline": round(exact_qps / BASELINE_READ_QPS, 3),
        "north_star_1M": {
            "qps": ns["qps"], "recall": ns["recall"],
            "vs_baseline": round(ns["qps"] / BASELINE_READ_QPS, 2),
            "engine": f"ivf nlist={nlist} nprobe=1, 1M x 768 bf16 clustered",
        },
        "north_star_1M_int8": {
            "qps": ns8["qps"], "recall": ns8["recall"],
            "vs_baseline": round(ns8["qps"] / BASELINE_READ_QPS, 2),
            "engine": f"ivf_int8 nlist={nlist} nprobe=1 (capacity config)",
        },
        "matrix": matrix,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    # Full matrix first, compact summary LAST: a reader of the output's tail
    # gets every headline number in one line.
    print(json.dumps(result), flush=True)
    e1m = matrix.get("flat_exact_1M", {})
    e1m256 = matrix.get("flat_exact_1M_b256", {})
    summary = {
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": result["vs_baseline"],
        "flat_exact_1M": {kk_: e1m.get(kk_) for kk_ in
                          ("qps", "qps_median", "recall", "note")},
        "flat_exact_1M_b256": {kk_: e1m256.get(kk_) for kk_ in
                               ("qps", "qps_median")},
        "north_star_1M": {kk_: ns.get(kk_) for kk_ in
                          ("qps", "qps_median", "recall")},
        "north_star_1M_int8": {kk_: ns8.get(kk_) for kk_ in
                               ("qps", "qps_median", "recall")},
        "ivf_int4_raw": {kk_: matrix.get(
            "ivf_int4_1M_clustered_nprobe1", {}).get(kk_)
            for kk_ in ("qps", "qps_median", "recall")},
        "ivf_int4_rescore": {kk_: matrix.get(
            "ivf_int4_rescore_1M_clustered_nprobe1", {}).get(kk_)
            for kk_ in ("qps", "qps_median", "recall")},
        "write_path_docs_per_s": matrix.get(
            "write_path_100k", {}).get("docs_per_s"),
        "write_path_docs_per_s_median": matrix.get(
            "write_path_100k", {}).get("docs_per_s_median"),
        "write_path_vs_baseline": matrix.get(
            "write_path_100k", {}).get("vs_write_baseline_13240"),
        "ingest_docs_per_s": matrix.get("ingest_100k", {}).get("docs_per_s"),
        "device": result["device"],
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
