"""Server-layer tests: real gRPC round trips over localhost + REST endpoints
(the reference's grpc/server.rs document/vector RPC delegations)."""

import json
import urllib.request

import numpy as np
import pytest

from grape_vector_db_tpu import Document, VectorDatabase, VectorDbConfig
from grape_vector_db_tpu.server.grpc_server import (
    VectorDbClient,
    build_grpc_server,
)
from grape_vector_db_tpu.server.proto import vector_db_pb2 as pb
from grape_vector_db_tpu.server.rest import RestServer


def small_db(dim=16):
    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.device.storage_dtype = "float32"
    cfg.index.initial_capacity = 128
    return VectorDatabase(config=cfg)


@pytest.fixture()
def grpc_pair():
    db = small_db()
    server, port, _ = build_grpc_server(db, port=0)
    server.start()
    client = VectorDbClient(f"127.0.0.1:{port}")
    yield db, client
    client.close()
    server.stop(grace=0)


def test_grpc_vector_roundtrip(grpc_pair, rng):
    db, client = grpc_pair
    pts = [
        pb.Point(id=f"v{i}", vector=pb.Vector(values=rng.standard_normal(16).astype(float)),
                 payload={"group": "a" if i % 2 == 0 else "b"})
        for i in range(20)
    ]
    resp = client.upsert_points(pts)
    assert resp.upserted == 20 and not resp.error

    got = client.call("GetVector", pb.GetVectorRequest(id="v3"))
    assert got.found and got.point.id == "v3"
    q = list(got.point.vector.values)
    sr = client.search(q, limit=3)
    assert sr.results[0].id == "v3"
    assert sr.results[0].payload["group"] == "b"

    # filtered search through SQL
    sr = client.search(q, limit=5, filter_sql="group = 'a'")
    assert sr.results and all(r.payload["group"] == "a" for r in sr.results)

    d = client.call("DeleteVector", pb.DeleteVectorRequest(ids=["v3"]))
    assert d.deleted == 1
    sr = client.search(q, limit=3)
    assert all(r.id != "v3" for r in sr.results)


def test_grpc_documents_and_modes(grpc_pair):
    db, client = grpc_pair
    docs = [
        pb.Document(id=f"d{i}", title=f"T{i}",
                    content=f"all about {'gpus' if i % 2 == 0 else 'pasta'} {i}",
                    metadata={"i": str(i)})
        for i in range(10)
    ]
    resp = client.call("AddDocument", pb.AddDocumentRequest(documents=docs))
    assert list(resp.ids) == [f"d{i}" for i in range(10)]

    got = client.call("GetDocument", pb.GetDocumentRequest(id="d4"))
    assert got.found and "gpus" in got.document.content

    for mode in ("semantic", "text", "hybrid"):
        sr = client.call(
            "SearchDocuments",
            pb.SearchDocumentsRequest(query="gpus", limit=5, mode=mode),
        )
        assert not sr.error
        if mode in ("text", "hybrid"):
            assert sr.results, f"no results in mode {mode}"
            assert all(int(r.id[1:]) % 2 == 0 for r in sr.results)

    stats = client.call("GetStats", pb.GetStatsRequest())
    assert stats.document_count == 10 and stats.index_size == 10

    metrics = client.call("GetMetrics", pb.GetMetricsRequest())
    assert "grape_vector_db_queries_total" in metrics.prometheus_text


def test_grpc_cluster_group_standalone(grpc_pair):
    _, client = grpc_pair
    info = client.call("GetClusterInfo", pb.GetClusterInfoRequest())
    assert info.cluster_id == "standalone" and len(info.members) == 1
    hb = client.call("Heartbeat", pb.HeartbeatRequest(node_id="x", term=1))
    assert hb.ok
    join = client.call("JoinCluster", pb.JoinClusterRequest(
        node=pb.NodeInfo(node_id="n2", address="h:1")))
    assert not join.accepted and "cluster mode" in join.error
    vote = client.call("RequestVote", pb.RequestVoteRequest(term=5, candidate_id="n2"))
    assert not vote.vote_granted


def test_grpc_error_paths(grpc_pair):
    _, client = grpc_pair
    # wrong-dimension upsert reported in-band
    resp = client.upsert_points([pb.Point(id="bad", vector=pb.Vector(values=[1.0]))])
    assert resp.upserted == 0 and "dim" in resp.error
    # bad SQL reported in-band
    sr = client.search([0.0] * 16, filter_sql="x ===")
    assert sr.error


# -- REST -------------------------------------------------------------------------


def _req(method, url, body=None):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(url, data=data, method=method,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture()
def rest():
    db = small_db()
    srv = RestServer(db, port=0)
    host, port = srv.start()
    yield db, f"http://{host}:{port}"
    srv.stop()


def test_rest_crud_and_search(rest, rng):
    db, base = rest
    vecs = rng.standard_normal((5, 16)).astype(float)
    code, out = _req("POST", f"{base}/api/v1/vectors", {
        "points": [{"id": f"r{i}", "vector": vecs[i].tolist(),
                    "metadata": {"odd": bool(i % 2)}} for i in range(5)]
    })
    assert code == 200 and out["upserted"] == 5

    code, out = _req("GET", f"{base}/api/v1/vectors/r2")
    assert code == 200 and len(out["vector"]) == 16

    code, out = _req("POST", f"{base}/api/v1/search",
                     {"mode": "vector", "vector": vecs[2].tolist(), "limit": 2})
    assert code == 200 and out["results"][0]["id"] == "r2"

    code, out = _req("DELETE", f"{base}/api/v1/vectors/r2")
    assert code == 200 and out["deleted"] == 1
    code, _ = _req("GET", f"{base}/api/v1/vectors/r2")
    assert code == 404


def test_rest_health_metrics_stats(rest):
    _, base = rest
    code, h = _req("GET", f"{base}/health")
    assert code == 200 and h["status"] == "healthy"
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        assert b"grape_vector_db_" in r.read()
    code, s = _req("GET", f"{base}/api/v1/stats")
    assert code == 200 and "document_count" in s


def test_rest_documents_batch_and_unknown_route(rest):
    _, base = rest
    code, out = _req("POST", f"{base}/api/v1/documents/batch", {
        "documents": [{"id": "a", "content": "hello gpu world"},
                      {"id": "b", "content": "pasta recipe"}]
    })
    assert code == 200 and out["ids"] == ["a", "b"]
    code, out = _req("POST", f"{base}/api/v1/search",
                     {"mode": "text", "query": "gpu", "limit": 5})
    assert code == 200 and out["results"][0]["id"] == "a"
    code, _ = _req("GET", f"{base}/api/v1/nope")
    assert code == 404


def test_serve_subprocess_end_to_end(tmp_path):
    """Boot the real `cli serve` entry point in a subprocess and talk to it
    over both protocols — the deployment artifact itself, not library calls."""
    import os
    import re
    import subprocess
    import sys
    import time

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "from grape_vector_db_tpu.cli import main;"
         f"main(['serve','--host','127.0.0.1','--grpc-port','0',"
         f"'--rest-port','0','--data-dir',{str(tmp_path / 'srv')!r}])"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        line = ""
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if "serving:" in line:
                break
        m = re.search(r"grpc=:(\d+) rest=([\d.]+):(\d+)", line)
        assert m, f"no serving banner: {line!r}"
        gport, rhost, rport = m.group(1), m.group(2), m.group(3)

        client = VectorDbClient(f"127.0.0.1:{gport}")
        resp = client.call("AddDocument", pb.AddDocumentRequest(documents=[
            pb.Document(id="sub-1", content="served from a subprocess"),
        ]))
        assert list(resp.ids) == ["sub-1"]
        got = client.call("GetDocument", pb.GetDocumentRequest(id="sub-1"))
        assert got.found
        client.close()

        code, health = _req("GET", f"http://{rhost}:{rport}/health")
        assert code == 200 and health["status"] == "healthy"
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_grpc_batched_concurrent_search(rng):
    """Concurrent unfiltered SearchVectors RPCs share device batches through
    the micro-batching executor."""
    import concurrent.futures

    db = small_db()
    server, port, servicer = build_grpc_server(db, port=0)
    server.start()
    client = VectorDbClient(f"127.0.0.1:{port}")
    try:
        vecs = rng.standard_normal((20, 16)).astype(float)
        client.upsert_points([
            pb.Point(id=f"b{i}", vector=pb.Vector(values=vecs[i])) for i in range(20)
        ])

        def one(i):
            r = client.call("SearchVectors", pb.SearchVectorsRequest(
                query=pb.Vector(values=vecs[i]), limit=3, with_payload=False))
            return r.results[0].id

        with concurrent.futures.ThreadPoolExecutor(max_workers=12) as ex:
            got = list(ex.map(one, range(12)))
        assert got == [f"b{i}" for i in range(12)]
        assert servicer.batcher.queries_run >= 12
        assert servicer.batcher.batches_run < 12  # actually batched
    finally:
        client.close()
        server.stop(grace=0)


def test_grpc_api_key_enforcement(rng):
    """With enterprise enabled, data RPCs demand a valid x-api-key with the
    right role (in-band error reporting, matching the other handlers)."""
    import grpc
    from grape_vector_db_tpu.services.enterprise import Role

    db = small_db()
    auth = db.enable_enterprise()
    writer = auth.create_api_key("w", Role.DATA_MANAGER)
    reader = auth.create_api_key("r", Role.READ_ONLY_USER)
    server, port, _ = build_grpc_server(db, port=0)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        def call(method, req_msg, resp_cls, key=None):
            stub = channel.unary_unary(
                f"/grape.vectordb.VectorDbService/{method}",
                request_serializer=type(req_msg).SerializeToString,
                response_deserializer=resp_cls.FromString,
            )
            md = (("x-api-key", key),) if key else ()
            return stub(req_msg, metadata=md, timeout=10)

        pt = pb.Point(id="a1", vector=pb.Vector(values=[1.0] * 16))
        # no key -> rejected
        r = call("UpsertVector", pb.UpsertVectorRequest(points=[pt]),
                 pb.UpsertVectorResponse)
        assert "unauthorized" in r.error and r.upserted == 0
        # reader key cannot write
        r = call("UpsertVector", pb.UpsertVectorRequest(points=[pt]),
                 pb.UpsertVectorResponse, key=reader.key)
        assert "unauthorized" in r.error
        # writer key works
        r = call("UpsertVector", pb.UpsertVectorRequest(points=[pt]),
                 pb.UpsertVectorResponse, key=writer.key)
        assert r.upserted == 1
        # reader can search
        r = call("SearchVectors", pb.SearchVectorsRequest(
            query=pb.Vector(values=[1.0] * 16), limit=1), pb.SearchVectorsResponse,
            key=reader.key)
        assert not r.error and r.results[0].id == "a1"
    finally:
        channel.close()
        server.stop(grace=0)


# -- TLS (reference enterprise.rs:786,874 TlsConfig — enforced here) -----------------


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    from grape_vector_db_tpu.testing.certs import make_test_certs

    return make_test_certs(str(tmp_path_factory.mktemp("certs")),
                           with_client=True)


def test_grpc_tls_roundtrip_and_insecure_rejected(certs, rng):
    import grpc

    from grape_vector_db_tpu.config import TlsConfig

    db = small_db()
    srv_tls = TlsConfig(enabled=True, cert_path=certs["cert"],
                        key_path=certs["key"])
    server, port, _ = build_grpc_server(db, port=0, tls=srv_tls)
    server.start()
    try:
        cli_tls = TlsConfig(enabled=True, ca_path=certs["ca"],
                            target_name_override="localhost")
        client = VectorDbClient(f"127.0.0.1:{port}", tls=cli_tls)
        pts = [pb.Point(id="t1", vector=pb.Vector(
            values=rng.standard_normal(16).astype(float)))]
        resp = client.upsert_points(pts)
        assert resp.upserted == 1 and not resp.error
        sr = client.search(list(pts[0].vector.values), limit=1)
        assert sr.results[0].id == "t1"
        client.close()

        # plaintext client against the TLS port must fail, not silently work
        bad = VectorDbClient(f"127.0.0.1:{port}", timeout_s=2.0)
        with pytest.raises(grpc.RpcError):
            bad.search([0.0] * 16, limit=1)
        bad.close()
    finally:
        server.stop(grace=0)
        db.close()


def test_grpc_mtls_requires_client_cert(certs, rng):
    import grpc

    from grape_vector_db_tpu.config import TlsConfig

    db = small_db()
    srv_tls = TlsConfig(enabled=True, cert_path=certs["cert"],
                        key_path=certs["key"], ca_path=certs["ca"],
                        require_client_auth=True)
    server, port, _ = build_grpc_server(db, port=0, tls=srv_tls)
    server.start()
    try:
        # with a client cert: accepted
        good = VectorDbClient(f"127.0.0.1:{port}", tls=TlsConfig(
            enabled=True, ca_path=certs["ca"],
            cert_path=certs["client_cert"], key_path=certs["client_key"],
            require_client_auth=True, target_name_override="localhost"))
        assert not good.search([0.0] * 16, limit=1).error
        good.close()
        # without: handshake refused
        anon = VectorDbClient(f"127.0.0.1:{port}", timeout_s=2.0, tls=TlsConfig(
            enabled=True, ca_path=certs["ca"],
            target_name_override="localhost"))
        with pytest.raises(grpc.RpcError):
            anon.search([0.0] * 16, limit=1)
        anon.close()
    finally:
        server.stop(grace=0)
        db.close()


def test_rest_tls(certs, rng):
    import ssl

    from grape_vector_db_tpu.config import TlsConfig

    db = small_db()
    db.batch_add_documents([
        Document(id="r1", content="hello tls",
                 vector=rng.standard_normal(16).astype(np.float32).tolist())
    ])
    srv = RestServer(db, port=0, tls=TlsConfig(
        enabled=True, cert_path=certs["cert"], key_path=certs["key"]))
    host, port = srv.start()
    try:
        ctx = ssl.create_default_context(cafile=certs["ca"])
        # cert SAN covers localhost/127.0.0.1
        with urllib.request.urlopen(f"https://127.0.0.1:{port}/health",
                                    context=ctx, timeout=5) as r:
            assert json.loads(r.read())["status"] in ("healthy", "ok")
        # plain http against the TLS port fails
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2)
    finally:
        srv.stop()
        db.close()


def test_grpc_search_ef_reaches_ivf(rng):
    """The wire-level ef (SearchVectorsRequest.ef) must reach the IVF engine
    as a per-request nprobe override: an inter-cluster query at nprobe=1
    returns a different (wider) candidate set at ef=nlist."""
    from grape_vector_db_tpu import Document

    dim = 16
    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.device.storage_dtype = "float32"
    cfg.index.kind = "ivf"
    cfg.index.initial_capacity = 1024
    cfg.index.nlist = 4
    cfg.index.nprobe = 1
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    centers = rng.standard_normal((4, dim)).astype(np.float32) * 4
    pts = np.concatenate([c + 0.4 * rng.standard_normal((30, dim)).astype(np.float32)
                          for c in centers])
    db.batch_add_documents([Document(id=f"d{i}", content=f"c{i}",
                                     vector=pts[i].tolist())
                            for i in range(len(pts))])
    db.index.optimize()
    server, port, _ = build_grpc_server(db, port=0)
    server.start()
    client = VectorDbClient(f"127.0.0.1:{port}")
    try:
        q = ((centers[0] + centers[1]) / 2.0).astype(float).tolist()
        narrow = client.search(q, limit=20)
        wide = client.search(q, limit=20, ef=4)
        assert not narrow.error and not wide.error
        assert len(wide.results) >= len(narrow.results)
    finally:
        client.close()
        server.stop(grace=0)


def test_grpc_search_host_rescore_reaches_engine(rng):
    """SearchVectorsRequest.host_rescore must reach the query engine as a
    per-request host-tier rescore: a codes-only int4 index misorders tight
    clusters on-device; the wire knob restores the exact order from the
    store's full-precision embeddings."""
    dim = 64
    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.device.storage_dtype = "float32"
    cfg.index.kind = "ivf_int4"
    cfg.index.initial_capacity = 1024
    cfg.index.nlist = 4
    cfg.index.nprobe = 4
    cfg.index.int8_rescore = 0
    cfg.index.ivf_int8_keep_bf16 = False
    cfg.cache.enabled = False
    db = VectorDatabase(config=cfg)
    centers = rng.standard_normal((4, dim)).astype(np.float32) * 2
    pts = np.concatenate([c + 0.05 * rng.standard_normal((50, dim)).astype(np.float32)
                          for c in centers])
    db.batch_add_documents([Document(id=f"d{i}", content=f"c{i}",
                                     vector=pts[i].tolist())
                            for i in range(len(pts))])
    server, port, _ = build_grpc_server(db, port=0)
    server.start()
    client = VectorDbClient(f"127.0.0.1:{port}")
    try:
        vn = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        qsel = [3, 57, 101, 155]
        ok_raw = ok_resc = 0
        for qi in qsel:
            want = {f"d{j}" for j in np.argsort(-(vn[qi] @ vn.T))[:5]}
            raw = client.search(pts[qi].astype(float).tolist(), limit=5)
            resc = client.search(pts[qi].astype(float).tolist(), limit=5,
                                 host_rescore=192)
            assert not raw.error and not resc.error
            ok_raw += len({r.id for r in raw.results} & want)
            ok_resc += len({r.id for r in resc.results} & want)
        assert ok_resc >= 19, (ok_raw, ok_resc)   # exact order restored
        assert ok_resc > ok_raw, (ok_raw, ok_resc)
    finally:
        client.close()
        server.stop(grace=0)


def test_rest_search_host_rescore(rest, rng):
    """REST /api/v1/search accepts host_rescore (explicit 0 disables; a
    positive width re-ranks against stored embeddings and returns exact
    cosine scores)."""
    _, base = rest
    vecs = rng.standard_normal((8, 16)).astype(float)
    code, out = _req("POST", f"{base}/api/v1/vectors", {
        "points": [{"id": f"h{i}", "vector": vecs[i].tolist()}
                   for i in range(8)]})
    assert code == 200 and out["upserted"] == 8
    code, out = _req("POST", f"{base}/api/v1/search",
                     {"mode": "vector", "vector": vecs[3].tolist(),
                      "limit": 3, "host_rescore": 8})
    assert code == 200 and out["results"][0]["id"] == "h3"
    assert abs(out["results"][0]["score"] - 1.0) < 1e-3
    code, out = _req("POST", f"{base}/api/v1/search",
                     {"mode": "vector", "vector": vecs[3].tolist(),
                      "limit": 3, "host_rescore": 0})
    assert code == 200 and out["results"][0]["id"] == "h3"
