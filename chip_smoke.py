#!/usr/bin/env python3
"""Proof that the system runs on an NVIDIA GPU, end to end, at a real size.

    python chip_smoke.py             # one GPU: every single-device phase
    python chip_smoke.py --chips 4   # four GPUs: the sharded phases only

The deployment is VectorDBBench's Performance768D1M case: 1M x 768-d rows,
cosine, top-10. Rows are a seeded clustered Gaussian mixture with unit norm;
nothing is downloaded. One process drives everything through the entry points
a user calls (``VectorDatabase``, ``EmbeddedVectorDB`` with its batching
executor, the REST server), compiles every kernel of the path for the card
(none in interpret mode), and checks the results against a plain numpy
float32 reference on the same bf16-rounded rows and bf16-rounded unit queries
the device sees.

Earlier lines name the card and its power limit, the engine that served each
phase, each comparison with its tolerance, the scan step's memory analysis,
and kernel-versus-XLA times. The last line is the JSON verdict. Exits
non-zero, with no verdict line, when JAX finds no GPU, when the program is
not beside this file, or when any phase fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Scores are f32 sums of 768 bf16 x bf16 products; the device and numpy add
# them in different orders, which moves a score by up to ~768 * 2^-24 * sum
# |terms| (< 5e-5 for unit rows). 1e-4 bounds that; an id may differ from the
# reference only where its reference score is within the same 1e-4 of the
# 10th score (an order swap between near-ties).
SCORE_TOL = 1e-4
K = 10
# bench floors for the probe kinds (recall@10 vs the exact reference)
RECALL_FLOOR = {"ivf": 0.95, "ivf_int8": 0.85, "ivf_int4": 0.85}


class PhaseError(AssertionError):
    pass


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def timed_ab(kernel, xla, iters: int = 10) -> dict:
    """Median per-call ms of two callables timed in turns (K, X, X, K), each
    call ending in block_until_ready."""
    import jax

    def run(fn):
        out = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    jax.block_until_ready(kernel())
    jax.block_until_ready(xla())
    k1, x1, x2, k2 = run(kernel), run(xla), run(xla), run(kernel)
    return {"kernel_ms": round(statistics.median(k1 + k2), 4),
            "xla_ms": round(statistics.median(x1 + x2), 4)}


# -- data and reference ------------------------------------------------------


def mixture(n: int, d: int, seed: int, clusters: int = 1024,
            noise: float = 0.05, chunk: int = 1 << 18):
    """Clustered Gaussian mixture with unit-norm rows, generated on the
    device in chunks and rounded to bf16 (the storage type, so the rows the
    device stores are exactly these): (host rows [n, d] f32, device cluster
    centres)."""
    import jax
    import jax.numpy as jnp

    kc, key = jax.random.split(jax.random.PRNGKey(seed))
    cents = jax.random.normal(kc, (clusters, d), jnp.float32)
    cents = cents / jnp.linalg.norm(cents, axis=1, keepdims=True)

    @jax.jit
    def rows(key, cents):
        ka, kn = jax.random.split(key)
        a = jax.random.randint(ka, (chunk,), 0, clusters)
        x = cents[a] + noise * jax.random.normal(kn, (chunk, d), jnp.float32)
        # leaves the jit as bf16: an f32 -> bf16 -> f32 pair inside one
        # program may be dropped by XLA as excess precision
        return (x / jnp.linalg.norm(x, axis=1, keepdims=True)
                ).astype(jnp.bfloat16)

    host = np.empty((n, d), np.float32)
    for s in range(0, n, chunk):
        key, sub = jax.random.split(key)
        m = min(chunk, n - s)
        host[s:s + m] = np.asarray(rows(sub, cents))[:m].astype(np.float32)
    return host, cents


def queries_like(cents, b: int, seed: int, noise: float = 0.05):
    import jax
    import jax.numpy as jnp

    ka, kn = jax.random.split(jax.random.PRNGKey(seed + 1), 2)
    a = jax.random.randint(ka, (b,), 0, cents.shape[0])
    x = cents[a] + noise * jax.random.normal(kn, (b, cents.shape[1]))
    return np.asarray(x, np.float32)


class Reference:
    """Plain numpy float32 cosine top-k over the rows the device stores
    (bf16-valued), for bf16-rounded unit queries."""

    def __init__(self, rows_bf16_f32: np.ndarray):
        self.rows = rows_bf16_f32
        self.norms = np.linalg.norm(self.rows, axis=1).astype(np.float32)

    @staticmethod
    def queries(q: np.ndarray) -> np.ndarray:
        import jax.numpy as jnp

        qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        return np.asarray(jnp.asarray(qn, jnp.float32).astype(jnp.bfloat16),
                          np.float32)

    def scores(self, q: np.ndarray, allowed: np.ndarray | None = None):
        qb = self.queries(q)
        out = np.empty((q.shape[0], self.rows.shape[0]), np.float32)
        step = 1 << 18
        for s in range(0, self.rows.shape[0], step):
            out[:, s:s + step] = (qb @ self.rows[s:s + step].T) / self.norms[
                s:s + step]
        if allowed is not None:
            out[:, ~allowed] = -np.inf
        return np.minimum(out, 1.0)

    def topk(self, q: np.ndarray, k: int = K, allowed=None):
        sc = self.scores(q, allowed)
        idx = np.argpartition(-sc, k, axis=1)[:, :k]
        order = np.argsort(-np.take_along_axis(sc, idx, 1), axis=1)
        idx = np.take_along_axis(idx, order, 1)
        return idx, np.take_along_axis(sc, idx, 1), sc


def compare_exact(name: str, got_ids, got_scores, ref_sc: np.ndarray,
                  ref_idx: np.ndarray) -> None:
    """Top-k sets match the reference; an id outside the reference top-k
    is allowed only where its reference score is within SCORE_TOL of the
    k-th score; every returned score is within SCORE_TOL of its reference
    score."""
    worst = 0.0
    for r, (ids, scs) in enumerate(zip(got_ids, got_scores)):
        check(len(ids) == ref_idx.shape[1],
              f"{name}: query {r} returned {len(ids)} hits")
        kth = ref_sc[r, ref_idx[r, -1]]
        for i, s in zip(ids, scs):
            rs = ref_sc[r, i]
            worst = max(worst, abs(float(s) - float(rs)))
            if i not in set(ref_idx[r].tolist()):
                check(rs >= kth - SCORE_TOL,
                      f"{name}: query {r} id {i} scores {rs} < 10th {kth}")
        check(len(set(ids)) == len(ids), f"{name}: duplicate ids in {r}")
    check(worst <= SCORE_TOL, f"{name}: score diff {worst} > {SCORE_TOL}")
    log(f"  {name}: top-{ref_idx.shape[1]} matches the numpy reference "
        f"(max |score diff| {worst:.2e} <= {SCORE_TOL})")


def recall(got_ids, ref_idx) -> float:
    hit = sum(len(set(g) & set(r.tolist())) for g, r in zip(got_ids, ref_idx))
    return hit / ref_idx.size


def ids_scores(rows):
    """[[ScoredPoint | (id, score)]] -> (row ints, scores) with ids "d<row>"."""
    ids, scs = [], []
    for row in rows:
        ids.append([int((h.id if hasattr(h, "id") else h[0])[1:])
                    for h in row])
        scs.append([float(h.score if hasattr(h, "score") else h[1])
                    for h in row])
    return ids, scs


def lowered_has(fn, name: str, *args, **kw) -> bool:
    """Whether the compiled GPU program of fn(*args) calls the Triton kernel
    ``name`` — a kernel that gave way to the XLA form or ran in interpret
    mode leaves no such call."""
    txt = fn.lower(*args, **kw).as_text()
    return "xla.gpu.triton" in txt and name in txt


# -- single-device phases ------------------------------------------------------


def make_docs(host_rows: np.ndarray, with_bucket: bool = False):
    from grape_vector_db_tpu import Document

    return [Document(id=f"d{i}", content=f"doc {i}", vector=host_rows[i],
                     metadata={"bucket": i % 100} if with_bucket else {})
            for i in range(host_rows.shape[0])]


def make_db(kind: str, n: int, dim: int, nlist: int = 2048,
            nprobe: int = 16, data_dir=None):
    from grape_vector_db_tpu import VectorDatabase, VectorDbConfig

    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.index.kind = kind
    cfg.index.nlist = nlist
    cfg.index.nprobe = nprobe
    # flat: capacity = the corpus; IVF: two list capacities of headroom over
    # the mean fill, so the clustered lists rarely spill
    cfg.index.initial_capacity = n if kind == "flat" else 2 * n
    cfg.cache.enabled = False
    cfg.device.auto_shard = False
    return VectorDatabase(path=data_dir, config=cfg)


def ingest(db, docs, batch: int = 131_072) -> float:
    t0 = time.perf_counter()
    for s in range(0, len(docs), batch):
        db.batch_add_documents(docs[s:s + batch])
    return time.perf_counter() - t0


def phase_flat(ctx) -> None:
    """flat at full size through VectorDatabase: ingest, batched search at
    B = 128 and 256 through the segment-max kernel, single search, REST."""
    import jax.numpy as jnp

    from grape_vector_db_tpu import SearchRequest
    from grape_vector_db_tpu.ops.distance import exact_engine, scored_topk

    n, d = ctx["n"], ctx["d"]
    db = make_db("flat", n, d)
    dt = ingest(db, ctx["docs"])
    idx = db.index
    cap = idx.vectors.shape[0]
    log(f"  ingest {n} docs in {dt:.1f} s; capacity {cap}")
    for b in (128, 256):
        q = ctx["queries"][:b]
        eng = exact_engine(cap, d, b, K, idx.storage_dtype, "cosine")
        log(f"  flat B={b}: engine {eng}")
        check(not ctx["on_gpu"] or eng == "segmax_kernel",
              f"flat B={b} routed to {eng}")
        if ctx["on_gpu"]:
            check(lowered_has(scored_topk, "segmax_scan", jnp.asarray(q),
                              idx.vectors, idx.norms, idx.valid, k=K),
                  "flat scan: compiled program has no segmax kernel call")
        ref_idx, _, ref_sc = ctx["ref"].topk(q)
        ids, scs = ids_scores(db.vector_search_batch(q, K))
        compare_exact(f"flat B={b}", ids, scs, ref_sc, ref_idx)
    hits = db.vector_search(SearchRequest(vector=ctx["queries"][0].tolist(),
                                          limit=K))
    ids, scs = ids_scores([hits])
    ref_idx, _, ref_sc = ctx["ref"].topk(ctx["queries"][:1])
    compare_exact("flat single search (B=1)", ids, scs, ref_sc, ref_idx)
    phase_rest(ctx, db)
    if ctx["on_gpu"]:
        kernel_vs_xla_scan(ctx, idx)
    db.close()


def kernel_vs_xla_scan(ctx, idx) -> None:
    """The scan kernel against its XLA form on the index's own arrays: same
    indices, values within SCORE_TOL; both timed end to end."""
    import jax
    import jax.numpy as jnp

    from grape_vector_db_tpu.ops.distance import (_segmax_exact_topk,
                                                  prepare_queries)
    from grape_vector_db_tpu.ops.distance import score_weights
    from grape_vector_db_tpu.ops.segmax_pallas import (segmax_scores,
                                                       segmax_topk)

    vecs, norms, valid = idx.vectors, idx.norms, idx.valid

    # the corpus is an argument, not a closed-over constant: a captured
    # 1.5 GB array would be baked into the executable
    @jax.jit
    def xla_topk(q, vecs, norms, valid):
        return _segmax_exact_topk(prepare_queries(q, "cosine"), vecs, norms,
                                  valid, K, "cosine", 65536)

    def xla(q):
        return xla_topk(q, vecs, norms, valid)

    for b in (128, 256):
        q = jnp.asarray(ctx["queries"][:b])
        kv, ki = segmax_topk(q, vecs, norms, valid, k=K, metric="cosine")
        xv, xi = xla(q)
        same = same_up_to_ties(f"scan kernel vs XLA B={b}", kv, ki, xv, xi)
        dv = float(jnp.max(jnp.abs(kv - xv)))
        t = timed_ab(lambda: segmax_topk(q, vecs, norms, valid, k=K,
                                         metric="cosine"), lambda: xla(q))
        log(f"  scan kernel vs XLA B={b}: same idx {same:.4f}, max |dv| "
            f"{dv:.2e} <= {SCORE_TOL}; kernel {t['kernel_ms']} ms, "
            f"XLA {t['xla_ms']} ms")
        ctx["times"][f"scan_b{b}"] = t
    q = jnp.asarray(ctx["queries"][:128])
    w = score_weights(norms, valid, "cosine")
    mem = jax.jit(segmax_scores).lower(prepare_queries(q, "cosine"), vecs,
                                       w).compile().memory_analysis()
    log(f"  scan step memory_analysis (B=128): {mem}")


def phase_rest(ctx, db) -> None:
    """The REST surface answers /api/v1 searches from a stdlib client with
    the database's own results."""
    from grape_vector_db_tpu.server.rest import RestServer

    srv = RestServer(db, host="127.0.0.1", port=0)
    host, port = srv.start()
    try:
        for qi in range(3):
            body = json.dumps({"vector": ctx["queries"][qi].tolist(),
                               "limit": K}).encode()
            req = urllib.request.Request(
                f"http://{host}:{port}/api/v1/search", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                out = json.loads(resp.read())
            got = [r["id"] for r in out["results"]]
            want = [h.id for h in db.vector_search_batch(
                ctx["queries"][qi:qi + 1], K)[0]]
            check(got == want, f"REST search {qi}: {got} != {want}")
        with urllib.request.urlopen(f"http://{host}:{port}/api/v1/health",
                                    timeout=30) as resp:
            check(resp.status == 200, "REST health")
        log("  REST /api/v1/search x3 + /api/v1/health: answers match")
    finally:
        srv.stop()


def phase_ivf(ctx, kind: str) -> None:
    """An IVF kind at full size: recall@10 at nprobe = 16, exactness at
    nprobe = nlist, kernel-versus-XLA probe parity and times."""
    import jax.numpy as jnp

    from grape_vector_db_tpu import SearchParams, SearchRequest
    from grape_vector_db_tpu.ops.ivf_pallas import kernel_ivf_topk

    n, d = ctx["n"], ctx["d"]
    db = make_db(kind, n, d, nlist=ctx["nlist"])
    dt = ingest(db, ctx["docs_filter"] if kind == "ivf" else ctx["docs"])
    idx = db.index
    log(f"  ingest {n} docs in {dt:.1f} s; nlist {idx.nlist}, list cap "
        f"{idx.list_cap}, overflow {len(idx._overflow)}, engine "
        f"{'probe kernel' if idx._use_kernel else 'XLA probe'}")
    check(idx._use_kernel == ctx["on_gpu"], f"{kind}: probe routing")
    q = ctx["queries"][:128]
    ref_idx, _, ref_sc = ctx["ref"].topk(q)
    ids, scs = ids_scores(db.vector_search_batch(q, K))
    rc = recall(ids, ref_idx)
    log(f"  {kind} nprobe={idx.nprobe} B=128: recall@10 {rc:.4f} "
        f"(floor {RECALL_FLOOR[kind]})")
    check(rc >= RECALL_FLOOR[kind], f"{kind}: recall {rc}")
    # nprobe = nlist through the per-request dial: every list is scanned
    allq = ctx["queries"][:4]
    rows = [db.vector_search(SearchRequest(
        vector=v.tolist(), limit=K, params=SearchParams(ef=idx.nlist)))
        for v in allq]
    ids, scs = ids_scores(rows)
    ref_idx4, _, ref_sc4 = ctx["ref"].topk(allq)
    if kind == "ivf":
        compare_exact(f"{kind} nprobe=nlist", ids, scs, ref_sc4, ref_idx4)
    else:
        rc = recall(ids, ref_idx4)
        log(f"  {kind} nprobe=nlist: recall@10 {rc:.4f} (codes + bf16 "
            f"rescore of the top {idx._rescore_count(K)})")
        check(rc >= 0.95, f"{kind} nprobe=nlist recall {rc}")
    if ctx["on_gpu"]:
        data, plane, fmt = idx._scan_planes()
        check(lowered_has(kernel_ivf_topk, f"ivf_probe_{fmt}",
                          jnp.asarray(q), idx.centroids, data, plane, k=K,
                          nprobe=idx.nprobe, fmt=fmt, fill=idx._list_fill()),
              f"{kind}: compiled probe has no kernel call")
        kernel_vs_xla_probe(ctx, idx, kind)
    if kind == "ivf":
        phase_filtered(ctx, db)
    db.close()


def same_up_to_ties(name: str, kv, ki, xv, xi) -> float:
    """Kernel and XLA top-k agree: equal indices, or indices that differ
    only between near-ties (values within SCORE_TOL); values within
    SCORE_TOL. Returns the share of equal indices."""
    kv, xv = np.asarray(kv), np.asarray(xv)
    fin = np.isfinite(kv) & np.isfinite(xv)
    check(bool(np.all(fin == (np.isfinite(kv) | np.isfinite(xv)))),
          f"{name}: filled positions differ")
    dv = float(np.max(np.abs(kv[fin] - xv[fin]), initial=0.0))
    check(dv <= SCORE_TOL, f"{name}: |dv| {dv}")
    diff = np.asarray(ki) != np.asarray(xi)
    check(bool(np.all(np.abs(np.where(fin, kv - xv, 0.0))[diff]
                      <= SCORE_TOL)),
          f"{name}: indices differ beyond ties")
    return 1.0 - float(diff.mean())


def kernel_vs_xla_probe(ctx, idx, kind: str) -> None:
    """The probe kernel against its XLA form on the index's own arrays at
    nprobe = 16, B = 128, in three steps: (1) the per-cell code scores of
    the kernel (``ivf_probe_scores``) against the XLA gather-and-dot on the
    same probed lists — every cell within SCORE_TOL, invalid cells on both
    sides; (2) the top-10 of both score blocks through the one selection,
    with no rescore — same slots up to near-ties; (3) the product call
    ``_main_topk`` with the kernel on and off (including the kind's bf16
    rescore), compared the same way and timed end to end."""
    import jax
    import jax.numpy as jnp

    from grape_vector_db_tpu.ops.distance import prepare_queries, rowwise_dots
    from grape_vector_db_tpu.ops.int4 import unpack_int4
    from grape_vector_db_tpu.ops.ivf_pallas import ivf_probe_scores
    from grape_vector_db_tpu.ops.ivf_probe import (finalize_probe_topk,
                                                   probe_lists)

    data, plane, fmt = idx._scan_planes()
    fill = idx._list_fill()

    @jax.jit
    def xla_scores(qp, probe, data, plane):
        rows = data[probe]                                # [b, P, C, width]
        if fmt == "int4":
            rows = unpack_int4(rows)
        dots = rowwise_dots(qp, rows, q_dtype=None if fmt == "bf16"
                            else jnp.bfloat16)
        w = plane[probe]
        return jnp.where(w == 0.0, -1e9, dots * w)

    q = jnp.asarray(ctx["queries"][:128])
    qp = prepare_queries(q, idx.metric)
    probe = probe_lists(qp, idx.centroids, idx.nprobe, idx.metric)
    ks = np.asarray(ivf_probe_scores(qp, probe, data, plane, fill=fill,
                                     fmt=fmt))
    # the XLA form in query chunks: its [b, P, C, D] gather is the cost the
    # kernel avoids, and 32 queries of it fit beside the index
    xs = np.concatenate([np.asarray(xla_scores(qp[s:s + 32],
                                               probe[s:s + 32], data, plane))
                         for s in range(0, q.shape[0], 32)])
    live_k, live_x = ks > -1e8, xs > -1e8
    check(bool(np.array_equal(live_k, live_x)),
          f"{kind} probe cells: invalid cells differ "
          f"({int(np.sum(live_k != live_x))})")
    dc = float(np.max(np.abs(ks - xs)[live_k], initial=0.0))
    check(dc <= SCORE_TOL, f"{kind} probe cells: |dv| {dc}")
    log(f"  {kind} probe kernel vs XLA, code scores ({fmt}): "
        f"{int(live_k.sum())} live cells of {ks.size}, max |dv| {dc:.2e} "
        f"<= {SCORE_TOL}")
    kv, ki = finalize_probe_topk(qp, probe, jnp.asarray(ks), K, idx.metric)
    xv, xi = finalize_probe_topk(qp, probe, jnp.asarray(xs), K, idx.metric)
    same = same_up_to_ties(f"{kind} probe top-{K} (no rescore)", kv, ki,
                           xv, xi)
    log(f"  {kind} probe kernel vs XLA, top-{K} of the code scores: same "
        f"slots {same:.4f} (rest near-ties within {SCORE_TOL})")

    qh = np.asarray(q)
    r = idx._rescore_count(K) if kind != "ivf" else 0
    saved = idx._use_kernel

    def kern():
        return idx._main_topk(qh, K, None)

    def xla():
        idx._use_kernel = False
        try:
            return idx._main_topk(qh, K, None)
        finally:
            idx._use_kernel = saved

    kv, ki = kern()
    xv, xi = xla()
    same = same_up_to_ties(f"{kind} _main_topk", kv, ki, xv, xi)
    t = timed_ab(kern, xla)
    log(f"  {kind} _main_topk kernel vs XLA (nprobe={idx.nprobe}, B=128, "
        f"rescore {r}): same slots {same:.4f}; kernel {t['kernel_ms']} ms, "
        f"XLA {t['xla_ms']} ms")
    ctx["times"][f"probe_{kind}"] = t


def phase_filtered(ctx, db) -> None:
    """Exact filtered tiers at 1% selectivity (metadata bucket = 7): the
    compact gather-scan and the streaming scan, each exact against the
    masked reference."""
    from grape_vector_db_tpu import SearchRequest
    from grape_vector_db_tpu.engine.filtering import parse_sql_where

    db.engine.config.filter_exact_max = 0      # skip the host tier
    allowed = (np.arange(ctx["n"]) % 100) == 7
    q = ctx["queries"][:4]
    ref_idx, _, ref_sc = ctx["ref"].topk(q, allowed=allowed)
    idx = db.index
    for tier, budget in (("compact", idx.compact_max_bytes),
                         ("streaming", 0)):
        idx.compact_max_bytes = budget
        rows = [db.vector_search(SearchRequest(
            vector=v.tolist(), limit=K, filter=parse_sql_where("bucket = 7")))
            for v in q]
        ids, scs = ids_scores(rows)
        check(all(allowed[i] for row in ids for i in row),
              f"filtered {tier}: a disallowed id")
        compare_exact(f"filtered 1% {tier} tier", ids, scs, ref_sc, ref_idx)
    idx.compact_max_bytes = 1 << 30


def phase_embedded(ctx) -> None:
    """EmbeddedVectorDB with a data_dir at 100k docs: concurrent single
    queries through the batching executor from 8 threads, then close and
    reopen — every acknowledged write reads back, deletes stay deleted."""
    from grape_vector_db_tpu import (EmbeddedConfig, EmbeddedVectorDB,
                                     VectorDbConfig)

    n, d = ctx["n_small"], ctx["d"]
    rows = ctx["host_rows"][:n]
    ref = Reference(ctx["ref"].rows[:n])
    tmp = tempfile.mkdtemp(prefix="gvdb_smoke_")

    def cfg():
        c = EmbeddedConfig(data_dir=tmp, db=VectorDbConfig(vector_dimension=d))
        c.db.index.initial_capacity = n
        c.db.cache.enabled = False
        c.health_check_interval_s = 0
        return c

    docs = make_docs(rows)
    dead = [f"d{i}" for i in range(0, n, 997)]
    with EmbeddedVectorDB(cfg()) as edb:
        for s in range(0, n, 16_384):
            edb.upsert(docs[s:s + 16_384])
        edb.delete(dead)
        q = ctx["queries"][:64]
        out = [None] * len(q)

        def worker(t):
            for i in range(t, len(q), 8):
                out[i] = edb.vector_search_one(q[i], K)

        th = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for t in th:
            t.start()
        for t in th:
            t.join()
        alive = np.ones(n, bool)
        alive[[int(x[1:]) for x in dead]] = False
        ref_idx, _, ref_sc = ref.topk(q, allowed=alive)
        ids, scs = ids_scores(out)
        compare_exact("embedded 8-thread single queries (batching executor)",
                      ids, scs, ref_sc, ref_idx)
        log(f"  executor counters: {edb.executor.counters.snapshot()}")
    with EmbeddedVectorDB(cfg()) as edb:
        missing = [i for i in range(n)
                   if alive[i] and edb.get(f"d{i}") is None]
        check(not missing, f"reopen: {len(missing)} acknowledged writes lost")
        check(all(edb.get(x) is None for x in dead), "reopen: deletes lost")
        v = np.asarray(edb.get("d5").vector, np.float32)
        check(np.array_equal(v, rows[5]), "reopen: stored vector changed")
        ids, scs = ids_scores([edb.vector_search_one(q[0], K)])
        compare_exact("reopened search", ids, scs, ref_sc[:1], ref_idx[:1])
    log(f"  persistence: {n} writes, {len(dead)} deletes, reopened intact")


def single_chip(ctx) -> None:
    phases = [("flat 1M (segment-max kernel) + REST", phase_flat),
              ("ivf 1M (probe kernel, bf16) + filtered tiers",
               lambda c: phase_ivf(c, "ivf")),
              ("ivf_int8 1M (probe kernel, int8)",
               lambda c: phase_ivf(c, "ivf_int8")),
              ("ivf_int4 1M (probe kernel, int4)",
               lambda c: phase_ivf(c, "ivf_int4")),
              ("embedded 100k: batching executor + persistence",
               phase_embedded)]
    run_phases(ctx, phases)


# -- four-device phases -------------------------------------------------------


def phase_sharded(ctx, kind: str) -> None:
    """A sharded kind over the 4-device mesh against the single-device
    reference: each device holds its shard, results equal."""
    import jax

    from grape_vector_db_tpu.config import VectorDbConfig
    from grape_vector_db_tpu.db import build_index
    from grape_vector_db_tpu.parallel import make_mesh

    n, d, ndev = ctx["n"], ctx["d"], ctx["ndev"]
    cfg = VectorDbConfig(vector_dimension=d)
    cfg.index.kind = kind
    cfg.index.nlist = ctx["nlist"]
    cfg.index.nprobe = 16
    cfg.index.initial_capacity = n if kind == "sharded_flat" else 2 * n
    cfg.device.n_shards = ndev
    mesh = make_mesh(n_shards=ndev)
    before = [dv.memory_stats()["bytes_in_use"] if dv.memory_stats() else 0
              for dv in jax.devices()[:ndev]]
    idx = build_index(cfg, mesh=mesh)
    ids = [f"d{i}" for i in range(n)]
    t0 = time.perf_counter()
    for s in range(0, n, 262_144):
        idx.add_batch(ids[s:s + 262_144], ctx["host_rows"][s:s + 262_144])
    log(f"  {kind}: {n} rows over {ndev} devices in "
        f"{time.perf_counter() - t0:.1f} s")
    arr = idx.vectors if kind == "sharded_flat" else idx.codes
    devs = arr.sharding.device_set
    check(len(devs) == ndev, f"{kind}: data on {len(devs)} devices")
    for i, dv in enumerate(jax.devices()[:ndev]):
        ms = dv.memory_stats() or {}
        used = ms.get("bytes_in_use", 0) - before[i]
        shard = [s for s in arr.addressable_shards if s.device == dv]
        log(f"  device {i}: +{used / 2**30:.2f} GiB in use, shard "
            f"{shard[0].data.shape if shard else None}")
        check(shard and shard[0].data.nbytes < arr.nbytes,
              f"{kind}: device {i} holds no proper shard")
    # what lives on device 0 alone (not sharded, and not a view of a
    # shard): the single-device reference and whatever the build left there
    gc.collect()
    seen = {s.data.unsafe_buffer_pointer() for s in arr.addressable_shards}
    solo = []
    for a in sorted(jax.live_arrays(), key=lambda a: a.nbytes, reverse=True):
        ptr = a.unsafe_buffer_pointer() if a.is_fully_addressable and len(
            a.sharding.device_set) == 1 else None
        if a.sharding.device_set == {jax.devices()[0]} and ptr not in seen:
            seen.add(ptr)          # two Array objects may share one buffer
            solo.append(a)
    log(f"  device 0 alone: {len(solo)} arrays, "
        f"{sum(a.nbytes for a in solo) / 2**30:.2f} GiB; largest: "
        + ", ".join(f"{a.shape} {a.dtype} {a.nbytes / 2**30:.2f} GiB"
                    for a in solo[:5]))
    over = getattr(idx, "_overflow", None)
    if over is not None:
        log(f"  overflow region (unsharded, device 0): {len(over)} rows, "
            f"capacity {over.vectors.shape[0]}")
    q = ctx["queries"][:128]
    got = idx.search_batch(q, K)
    ids_, scs = ids_scores(got)
    ref_idx, _, ref_sc = ctx["ref"].topk(q)
    if kind == "sharded_flat":
        compare_exact(f"{kind} vs numpy reference", ids_, scs, ref_sc,
                      ref_idx)
        single = ctx["single_flat"]
        sids, _ = ids_scores(single.search_batch(q, K))
        same = np.mean([a == b for a, b in zip(ids_, sids)])
        log(f"  {kind} vs single-device flat: {same:.4f} of queries "
            "identical (rest differ only between near-ties)")
    else:
        rc = recall(ids_, ref_idx)
        log(f"  {kind} nprobe=16 B=128: recall@10 {rc:.4f} (floor "
            f"{RECALL_FLOOR['ivf_int8']})")
        check(rc >= RECALL_FLOOR["ivf_int8"], f"{kind}: recall {rc}")


def phase_replica_mesh(ctx) -> None:
    """A 2 x 2 replica x shard mesh serves the same results as the 1D
    four-shard mesh (the query batch splits over the replica rows)."""
    from grape_vector_db_tpu.parallel.mesh import (ShardedFlatIndex,
                                                   make_mesh_2d)

    import jax

    n, d = ctx["n"], ctx["d"]
    mesh = make_mesh_2d(n_replicas=2, devices=jax.devices()[:4])
    idx = ShardedFlatIndex(d, mesh=mesh, shard_capacity=n // 2,
                           replica_axis="replica")
    ids = [f"d{i}" for i in range(n)]
    for s in range(0, n, 262_144):
        idx.add_batch(ids[s:s + 262_144], ctx["host_rows"][s:s + 262_144])
    check(len(idx.vectors.sharding.device_set) == 4, "2x2: not on 4 devices")
    q = ctx["queries"][:128]
    ids_, scs = ids_scores(idx.search_batch(q, K))
    ref_idx, _, ref_sc = ctx["ref"].topk(q)
    compare_exact("2x2 replica x shard mesh", ids_, scs, ref_sc, ref_idx)


def four_chip(ctx) -> None:
    from grape_vector_db_tpu.index.flat import FlatDeviceIndex

    def single(c):
        """The single-device reference index: flat on device 0."""
        idx = FlatDeviceIndex(c["d"], initial_capacity=c["n"])
        ids = [f"d{i}" for i in range(c["n"])]
        for s in range(0, c["n"], 262_144):
            idx.add_batch(ids[s:s + 262_144], c["host_rows"][s:s + 262_144])
        c["single_flat"] = idx

    phases = [("single-device flat reference", single),
              ("sharded_flat 4M over 4 devices",
               lambda c: phase_sharded(c, "sharded_flat")),
              ("sharded_ivf_int8 4M over 4 devices",
               lambda c: phase_sharded(c, "sharded_ivf_int8")),
              ("2 x 2 replica x shard mesh", phase_replica_mesh)]
    run_phases(ctx, phases)


# -- driver ---------------------------------------------------------------------


def run_phases(ctx, phases) -> None:
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"PHASE {name}")
        try:
            fn(ctx)
        except Exception as e:  # every phase runs; any failure fails the run
            ctx["failed"].append(name)
            log(f"  FAILED: {type(e).__name__}: {str(e)[:2000]}")
        log(f"  ({time.perf_counter() - t0:.1f} s)")


def build_context(n: int, d: int, nq: int, seed: int, on_gpu: bool,
                  nlist: int, n_small: int, ndev: int = 1) -> dict:
    t0 = time.perf_counter()
    host_rows, cents = mixture(n, d, seed)
    queries = queries_like(cents, nq, seed)
    ctx = {
        "n": n, "d": d, "nlist": nlist, "n_small": n_small, "ndev": ndev,
        "on_gpu": on_gpu, "host_rows": host_rows, "ref": Reference(host_rows),
        "queries": queries, "failed": [], "times": {},
    }
    if ndev == 1:
        ctx["docs"] = make_docs(host_rows)
        ctx["docs_filter"] = make_docs(host_rows, with_bucket=True)
    log(f"data: {n} x {d} clustered unit rows, {nq} queries, seed {seed} "
        f"({time.perf_counter() - t0:.1f} s)")
    return ctx


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{devs[0].platform}", file=sys.stderr)
        return 2
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but {len(devs)} devices",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from grape_vector_db_tpu.utils.compile_cache import (
            enable_compile_cache)
    except ImportError as e:
        print(f"chip_smoke: the program is not beside this file ({e})",
              file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    t_start = time.perf_counter()
    log(card())
    log(f"device_kind: {devs[0].device_kind}; devices: {len(devs)}; "
        f"jax {jax.__version__}; compile cache {cache}")
    if args.chips == 4:
        ctx = build_context(4 << 20, 768, 128, args.seed, True, nlist=4096,
                            n_small=0, ndev=4)
        four_chip(ctx)
        count = 4
    else:
        ctx = build_context(1 << 20, 768, 256, args.seed, True, nlist=2048,
                            n_small=100_000)
        single_chip(ctx)
        count = 1
    if ctx["times"]:
        log("kernel vs XLA (median ms): " + json.dumps(ctx["times"]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if ctx["failed"]:
        log(f"FAILED phases: {ctx['failed']}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
