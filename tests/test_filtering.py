"""Filter engine tests: every operator, set algebra, geo, SQL parsing —
including the operators the reference left stubbed (filtering.rs:430-431,
572-592)."""

import numpy as np
import pytest

from grape_vector_db_tpu.engine.filtering import FilterEngine, haversine_m, parse_sql_where
from grape_vector_db_tpu.types import Condition, Filter


@pytest.fixture
def engine():
    e = FilterEngine()
    docs = {
        "d1": {"category": "tech", "price": 10, "tags": ["gpu", "npu"],
               "loc": {"lat": 37.77, "lon": -122.42}, "title": "NPU guide"},
        "d2": {"category": "tech", "price": 50, "tags": ["cpu"],
               "loc": {"lat": 40.71, "lon": -74.00}, "title": "CPU handbook"},
        "d3": {"category": "food", "price": 5, "nested": {"a": {"b": 7}},
               "title": "Pasta recipes"},
        "d4": {"category": "food", "price": 20, "tags": ["pasta", "npu"]},
    }
    for i, m in docs.items():
        e.index_document(i, m)
    return e


def q(engine, node):
    return set(engine.execute_filter(node))


def test_eq_ne_in(engine):
    assert q(engine, Condition("category", "eq", "tech")) == {"d1", "d2"}
    assert q(engine, Condition("category", "ne", "tech")) == {"d3", "d4"}
    assert q(engine, Condition("category", "in", ["tech", "food"])) == {"d1", "d2", "d3", "d4"}


def test_numeric_ranges(engine):
    assert q(engine, Condition("price", "gt", 10)) == {"d2", "d4"}
    assert q(engine, Condition("price", "gte", 10)) == {"d1", "d2", "d4"}
    assert q(engine, Condition("price", "lt", 10)) == {"d3"}
    assert q(engine, Condition("price", "lte", 10)) == {"d1", "d3"}


def test_like_and_text_match(engine):
    assert q(engine, Condition("title", "like", "%guide%")) == {"d1"}
    assert q(engine, Condition("title", "like", "C_U handbook")) == {"d2"}
    assert q(engine, Condition("title", "text_match", "pasta")) == {"d3"}


def test_exists_null_array(engine):
    assert q(engine, Condition("tags", "exists")) == {"d1", "d2", "d4"}
    assert q(engine, Condition("tags", "is_null")) == {"d3"}
    assert q(engine, Condition("tags", "array_contains", "npu")) == {"d1", "d4"}


def test_nested_paths(engine):
    assert q(engine, Condition("nested.a.b", "eq", 7)) == {"d3"}
    assert q(engine, Condition("nested.a.b", "gte", 5)) == {"d3"}


def test_logical_combinators(engine):
    f = Filter(
        must=[Condition("category", "eq", "tech")],
        must_not=[Condition("price", "gt", 20)],
    )
    assert q(engine, f) == {"d1"}
    f2 = Filter(should=[Condition("price", "lt", 6), Condition("price", "gt", 40)])
    assert q(engine, f2) == {"d2", "d3"}
    nested = Filter(must=[f2, Condition("category", "eq", "food")])
    assert q(engine, nested) == {"d3"}


def test_geo_within_distance(engine):
    # 10 km around San Francisco: only d1
    got = q(engine, Condition("loc", "geo_within_distance",
                              {"lat": 37.7749, "lon": -122.4194, "radius_m": 10_000}))
    assert got == {"d1"}
    # coast-to-coast radius captures both
    got = q(engine, Condition("loc", "geo_within_distance",
                              {"lat": 39.0, "lon": -98.0, "radius_m": 4_000_000}))
    assert got == {"d1", "d2"}


def test_geo_bbox(engine):
    got = q(engine, Condition("loc", "geo_bounding_box",
                              {"min_lat": 35, "max_lat": 39, "min_lon": -125, "max_lon": -120}))
    assert got == {"d1"}


def test_haversine_known_distance():
    # SF -> NYC ~ 4130 km
    d = haversine_m(37.7749, -122.4194, 40.7128, -74.0060)
    assert 4.0e6 < float(d) < 4.3e6


def test_remove_and_reindex(engine):
    engine.remove_document("d1")
    assert q(engine, Condition("category", "eq", "tech")) == {"d2"}
    engine.index_document("d1", {"category": "food"})
    assert q(engine, Condition("category", "eq", "food")) == {"d1", "d3", "d4"}


def test_mask_for_slots(engine):
    slots = ["d1", "d2", None, "d3", "d4"]
    mask = engine.mask_for_slots(Condition("category", "eq", "tech"), slots)
    np.testing.assert_array_equal(mask, [True, True, False, False, False])


# -- SQL parser ----------------------------------------------------------------


def test_sql_simple(engine):
    f = parse_sql_where("category = 'tech' AND price >= 10")
    assert q(engine, f) == {"d1", "d2"}


def test_sql_or_not_parens(engine):
    f = parse_sql_where("(category = 'food' OR price > 40) AND NOT price < 6")
    assert q(engine, f) == {"d2", "d4"}


def test_sql_like_in_null(engine):
    assert q(engine, parse_sql_where("title LIKE '%handbook%'")) == {"d2"}
    assert q(engine, parse_sql_where("category IN ('food')")) == {"d3", "d4"}
    assert q(engine, parse_sql_where("tags IS NULL")) == {"d3"}
    assert q(engine, parse_sql_where("tags IS NOT NULL")) == {"d1", "d2", "d4"}


def test_sql_between(engine):
    assert q(engine, parse_sql_where("price BETWEEN 6 AND 25")) == {"d1", "d4"}


def test_sql_where_prefix_and_errors(engine):
    assert q(engine, parse_sql_where("WHERE price = 5")) == {"d3"}
    from grape_vector_db_tpu.errors import InvalidArgumentError
    with pytest.raises(InvalidArgumentError):
        parse_sql_where("price ===")


def test_like_literal_glob_metachars(engine):
    """Literal glob metacharacters in LIKE patterns match themselves."""
    engine.index_document("g1", {"title": "file[1].txt"})
    engine.index_document("g2", {"title": "file1.txt"})
    engine.index_document("g3", {"title": "anything at all"})
    assert q(engine, Condition("title", "like", "file[1]%")) == {"g1"}
    assert q(engine, Condition("title", "like", "%*%")) == set()  # literal *


def test_sql_parser_fuzz_roundtrip(rng):
    """Property fuzz: random filter ASTs rendered to SQL parse back to an
    equivalent filter (same evaluation on random documents)."""
    import random

    r = random.Random(7)
    eng = FilterEngine()
    for i in range(200):
        eng.index_document(f"f{i}", {
            "a": r.randint(0, 20),
            "b": r.choice(["x", "y", "z z", "it's"]),
            "c": r.random() * 100,
        })

    def rand_cond():
        kind = r.choice(["num", "str", "in", "null", "between", "like"])
        if kind == "num":
            op = r.choice([("gt", ">"), ("gte", ">="), ("lt", "<"),
                           ("lte", "<="), ("eq", "="), ("ne", "!=")])
            v = r.randint(0, 20)
            return Condition("a", op[0], v), f"a {op[1]} {v}"
        if kind == "str":
            v = r.choice(["x", "y", "z z", "it's"])
            sql_v = v.replace("'", "\\'")
            return Condition("b", "eq", v), f"b = '{sql_v}'"
        if kind == "in":
            vs = r.sample([0, 1, 2, 5, 9, 13], 3)
            return Condition("a", "in", vs), f"a IN ({', '.join(map(str, vs))})"
        if kind == "null":
            neg = r.random() < 0.5
            return (Condition("missing", "is_not_null" if neg else "is_null"),
                    f"missing IS {'NOT ' if neg else ''}NULL")
        if kind == "between":
            lo, hi = sorted((r.randint(0, 20), r.randint(0, 20)))
            return (Filter(must=[Condition("c", "gte", lo), Condition("c", "lte", hi)]),
                    f"c BETWEEN {lo} AND {hi}")
        return Condition("b", "like", "%z%"), "b LIKE '%z%'"

    def rand_tree(depth):
        if depth == 0 or r.random() < 0.4:
            return rand_cond()
        left_ast, left_sql = rand_tree(depth - 1)
        right_ast, right_sql = rand_tree(depth - 1)
        if r.random() < 0.5:
            return (Filter(must=[left_ast, right_ast]),
                    f"({left_sql}) AND ({right_sql})")
        return (Filter(should=[left_ast, right_ast]),
                f"({left_sql}) OR ({right_sql})")

    for _ in range(60):
        ast, sql = rand_tree(2)
        direct = set(eng.execute_filter(ast))
        parsed = set(eng.execute_filter(parse_sql_where(sql)))
        assert direct == parsed, (sql, direct ^ parsed)


# -- masked device search (the production mask_for_slots path) ---------------------


def _masked_oracle(vectors, allowed_rows, query, k):
    """Exact top-k over only the allowed rows (numpy, cosine)."""
    q = query / np.linalg.norm(query)
    v = vectors[allowed_rows]
    sims = (v @ q) / np.linalg.norm(v, axis=1)
    order = np.argsort(-sims)[:k]
    return [allowed_rows[i] for i in order]


def test_masked_search_exact_under_selective_filter():
    """A ~0.1%-selective filter returns exactly the oracle's top-k. The allowed rows are engineered to rank BELOW
    every over-fetch horizon (all other rows score higher), so the old
    over-fetch + host post-filter path provably cannot find them."""
    from grape_vector_db_tpu.index.flat import FlatDeviceIndex

    rng = np.random.default_rng(7)
    dim, n = 32, 4096
    query = rng.standard_normal(dim).astype(np.float32)
    qn = query / np.linalg.norm(query)
    # Most rows: strongly aligned with the query (score ~0.9+).
    vectors = (0.95 * qn[None, :]
               + 0.05 * rng.standard_normal((n, dim))).astype(np.float32)
    # 4 allowed rows (0.1%): pushed orthogonal so they rank dead last.
    allowed_rows = [17, 901, 2048, 4000]
    orth = rng.standard_normal((len(allowed_rows), dim)).astype(np.float32)
    orth -= np.outer(orth @ qn, qn)  # remove the query component
    orth /= np.linalg.norm(orth, axis=1, keepdims=True)
    for j, (r, v) in enumerate(zip(allowed_rows, orth)):
        # distinct small alignments (0.05, 0.10, ...) so the within-filter
        # ordering is well-separated, while still ranking dead last globally
        vectors[r] = v + (0.05 * (j + 1)) * qn
    ids = [f"r{i}" for i in range(n)]

    idx = FlatDeviceIndex(dim, storage_dtype="float32", initial_capacity=n)
    idx.add_batch(ids, vectors)

    allowed_ids = {f"r{i}" for i in allowed_rows}
    mask = idx.compile_mask(allowed_ids)
    assert mask.sum() == len(allowed_rows)

    hits = idx.search_batch(query[None, :], 4, mask=mask)[0]
    got = [h[0] for h in hits]
    want = [f"r{i}" for i in _masked_oracle(vectors, allowed_rows, query, 4)]
    assert got == want, (got, want)

    # sanity: the unmasked over-fetch path at any plausible horizon (< n)
    # contains none of the allowed rows in its top-1024
    unfiltered = idx.search_batch(query[None, :], 1024)[0]
    assert not ({h[0] for h in unfiltered} & allowed_ids)


@pytest.mark.parametrize("kind", ["binary", "ivf", "ivf_pq", "pq", "sharded"])
def test_masked_search_all_engines(kind):
    """Every mask-capable engine returns only allowed ids under a selective
    filter, and the exact engines return the oracle exactly."""
    rng = np.random.default_rng(3)
    dim, n, k = 32, 2048, 5
    vectors = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"r{i}" for i in range(n)]
    query = vectors[100] + 0.01 * rng.standard_normal(dim).astype(np.float32)
    allowed_rows = sorted(rng.choice(n, 40, replace=False).tolist())
    allowed_ids = {f"r{i}" for i in allowed_rows}

    if kind == "binary":
        from grape_vector_db_tpu.index.binary import BinaryDeviceIndex
        idx = BinaryDeviceIndex(dim, storage_dtype="float32",
                                initial_capacity=n, max_rescore=n)
    elif kind == "ivf":
        from grape_vector_db_tpu.index.ivf import IvfDeviceIndex
        idx = IvfDeviceIndex(dim, storage_dtype="float32", nlist=8, nprobe=8)
    elif kind == "ivf_pq":
        from grape_vector_db_tpu.index.ivf_pq import IvfPqDeviceIndex
        idx = IvfPqDeviceIndex(dim, storage_dtype="float32", nlist=8, nprobe=8,
                               n_sub=4, rescore_k=256)
    elif kind == "pq":
        from grape_vector_db_tpu.index.pq import PqDeviceIndex
        idx = PqDeviceIndex(dim, storage_dtype="float32", initial_capacity=n,
                            n_sub=4, max_rescore=n)
    else:
        from grape_vector_db_tpu.parallel.mesh import ShardedFlatIndex
        idx = ShardedFlatIndex(dim, storage_dtype="float32",
                               shard_capacity=n // 4)
    idx.add_batch(ids, vectors)
    if hasattr(idx, "train") and getattr(idx, "codebooks", 1) is None:
        idx.train(vectors)

    mask = idx.compile_mask(allowed_ids)
    hits = idx.search_batch(query[None, :], k, mask=mask)[0]
    got = [h[0] for h in hits]
    assert got and set(got) <= allowed_ids, (kind, got[:5])
    if kind in ("sharded",):  # exact engines must match the oracle exactly
        want = [f"r{i}" for i in _masked_oracle(vectors, allowed_rows, query, k)]
        assert got == want, (kind, got, want)


def test_planner_uses_masked_search(tmp_path):
    """End-to-end: a selective metadata filter through the public search API
    returns the exact allowed-only results (the planner's masked path)."""
    from grape_vector_db_tpu import (Document, SearchRequest, VectorDatabase,
                                     VectorDbConfig)

    cfg = VectorDbConfig(vector_dimension=16)
    cfg.device.storage_dtype = "float32"
    cfg.index.initial_capacity = 256
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    rng = np.random.default_rng(0)
    docs = [
        Document(id=f"d{i}", content=f"body {i}",
                 vector=rng.standard_normal(16).astype(np.float32).tolist(),
                 metadata={"vip": i < 3, "rank": i})
        for i in range(200)
    ]
    db.batch_add_documents(docs)
    assert db.index.supports_mask
    got = db.vector_search(SearchRequest(
        vector=docs[150].vector, limit=10,
        filter=Filter(must=[Condition("vip", "eq", True)]),
    ))
    assert {p.id for p in got} == {"d0", "d1", "d2"}
    db.close()
