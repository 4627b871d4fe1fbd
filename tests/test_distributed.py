"""Distributed-layer tests: shard routing, migration, replication policies,
failure detection/failover, load balancing, request routing — the intent of the
reference's disabled cluster_mode/distributed/resharding suites, running for
real against the in-process transport."""

import time

import numpy as np
import pytest

from grape_vector_db_tpu.distributed.load_balancer import (
    IntelligentLoadBalancer,
    LoadBalancerConfig,
)
from grape_vector_db_tpu.distributed.replication import (
    ReplicationManager,
    SyncPolicy,
)
from grape_vector_db_tpu.distributed.request_router import ClusterAwareRequestRouter
from grape_vector_db_tpu.distributed.shard import (
    ConsistentHashRing,
    ShardDataAccess,
    ShardManager,
    ShardMap,
)
from grape_vector_db_tpu.distributed.failover import (
    FailureDetector,
    FailoverManager,
    RecoveryKind,
)
from grape_vector_db_tpu.distributed.types import NodeInfo, NodeState
from grape_vector_db_tpu.errors import ReplicationError, UnavailableError


# -- consistent hash ring -------------------------------------------------------


def test_ring_distribution_and_stability():
    ring = ConsistentHashRing(virtual_nodes=100)
    for n in ("a", "b", "c"):
        ring.add_node(n)
    keys = [f"key-{i}" for i in range(3000)]
    owners = {k: ring.node_for(k) for k in keys}
    counts = {n: sum(1 for o in owners.values() if o == n) for n in ("a", "b", "c")}
    assert all(c > 500 for c in counts.values()), counts  # roughly balanced
    # removing one node only remaps its keys
    ring.remove_node("c")
    moved = sum(1 for k in keys if owners[k] != "c" and ring.node_for(k) != owners[k])
    assert moved == 0


def test_shard_map_ranges_and_routing():
    m = ShardMap(shard_count=16, replica_count=3)
    m.assign_all(["n0", "n1", "n2", "n3"])
    # every shard has 1 primary + 2 replicas, all distinct
    for info in m.shards.values():
        nodes = info.all_nodes()
        assert len(nodes) == 3 and len(set(nodes)) == 3
    # routing is deterministic and in range
    sid = m.shard_for_key("doc-123")
    assert 0 <= sid < 16
    assert m.shard_for_key("doc-123") == sid
    info = m.nodes_for_key("doc-123")
    assert info.shard_id == sid


def test_shard_map_promote_replica():
    m = ShardMap(shard_count=4, replica_count=2)
    m.assign_all(["a", "b", "c"])
    sid = next(s for s, i in m.shards.items() if i.primary_node == "a")
    old = m.shards[sid].replica_nodes[0]
    new_primary = m.promote_replica(sid, "a")
    assert new_primary == old
    assert m.shards[sid].primary_node == old


# -- migration over an in-memory data access ---------------------------------------


class DictDataAccess(ShardDataAccess):
    def __init__(self, shard_map):
        self.map = shard_map
        self.nodes = {}

    def ensure(self, nid):
        return self.nodes.setdefault(nid, {})

    def count_shard(self, nid, sid):
        return sum(1 for d in self.ensure(nid).values()
                   if self.map.shard_for_key(d["id"]) == sid)

    def pull_shard(self, nid, sid):
        return [d for d in self.ensure(nid).values()
                if self.map.shard_for_key(d["id"]) == sid]

    def push_docs(self, nid, docs):
        store = self.ensure(nid)
        for d in docs:
            store[d["id"]] = d
        return len(docs)

    def drop_shard(self, nid, sid):
        store = self.ensure(nid)
        ids = [k for k in store if self.map.shard_for_key(k) == sid]
        for k in ids:
            del store[k]
        return len(ids)


def test_shard_migration_pipeline():
    m = ShardMap(shard_count=4, replica_count=1)
    m.assign_all(["a", "b"])
    data = DictDataAccess(m)
    mgr = ShardManager(m, data)
    # load docs onto their primaries
    for i in range(200):
        d = {"id": f"doc-{i}", "updated_at": i}
        info = m.nodes_for_key(d["id"])
        data.push_docs(info.primary_node, [d])
    sid = next(s for s, i in m.shards.items() if i.primary_node == "a")
    before = data.count_shard("a", sid)
    assert before > 0
    report = mgr.migrate_shard(sid, "b")
    assert report.verified and report.docs_moved == before
    assert m.shards[sid].primary_node == "b"
    assert data.count_shard("a", sid) == 0
    assert data.count_shard("b", sid) == before


def test_rebalance_plan_equalizes():
    m = ShardMap(shard_count=8, replica_count=1)
    m.assign_all(["a"])  # all 8 shards on a
    data = DictDataAccess(m)
    mgr = ShardManager(m, data)
    moves = mgr.plan_rebalance(["a", "b"])
    assert len(moves) >= 3
    assert all(dst == "b" for _, dst in moves)
    mgr.rebalance(["a", "b"])
    assert 3 <= len(m.shards_on_node("b", primary_only=True)) <= 5


# -- replication -------------------------------------------------------------------


def make_repl(policy, fail_nodes=()):
    written = {}

    def write(nid, docs):
        if nid in fail_nodes:
            raise ConnectionError(f"{nid} down")
        written.setdefault(nid, []).extend(docs)
        return len(docs)

    return ReplicationManager(write, policy=policy, replica_timeout_s=0.5), written


def test_replication_synchronous_all_acks():
    mgr, written = make_repl(SyncPolicy.SYNCHRONOUS)
    r = mgr.replicate([{"id": "x"}], "p", ["r1", "r2"])
    assert r.acks == 3
    assert set(written) == {"p", "r1", "r2"}
    mgr.close()


def test_replication_sync_fails_on_dead_replica():
    mgr, _ = make_repl(SyncPolicy.SYNCHRONOUS, fail_nodes={"r2"})
    with pytest.raises(ReplicationError):
        mgr.replicate([{"id": "x"}], "p", ["r1", "r2"])
    mgr.close()


def test_replication_quorum_tolerates_one_dead():
    mgr, written = make_repl(SyncPolicy.QUORUM, fail_nodes={"r2"})
    r = mgr.replicate([{"id": "x"}], "p", ["r1", "r2"])
    assert r.acks == 2  # p + r1 = majority of 3
    mgr.close()


def test_replication_async_returns_immediately():
    mgr, written = make_repl(SyncPolicy.ASYNCHRONOUS)
    r = mgr.replicate([{"id": "x"}], "p", ["r1"])
    assert r.acks == 1 and r.pending_async == 1
    time.sleep(0.2)
    assert "r1" in written
    health = mgr.replica_health()
    assert health["p"].confirm_rate == 1.0
    mgr.close()


def test_replication_primary_failure_raises():
    mgr, _ = make_repl(SyncPolicy.QUORUM, fail_nodes={"p"})
    with pytest.raises(ReplicationError, match="primary"):
        mgr.replicate([{"id": "x"}], "p", ["r1"])
    mgr.close()


# -- failure detector ----------------------------------------------------------------


def test_failure_detector_thresholds():
    up = {"n1": True}
    events = []
    det = FailureDetector(lambda n: up[n], fail_after=3, recover_after=2,
                          on_state_change=lambda n, s: events.append((n, s.value)))
    det.watch("n1")
    det.probe_all()
    assert det.state_of("n1") == NodeState.HEALTHY
    up["n1"] = False
    det.probe_all()
    assert det.state_of("n1") == NodeState.SUSPECTED
    det.probe_all(); det.probe_all()
    assert det.state_of("n1") == NodeState.FAILED
    up["n1"] = True
    det.probe_all()
    assert det.state_of("n1") == NodeState.RECOVERING
    det.probe_all()
    assert det.state_of("n1") == NodeState.HEALTHY
    kinds = [s for _, s in events]
    assert kinds == ["suspected", "failed", "recovering", "healthy"]


def test_failover_promotes_and_replaces():
    m = ShardMap(shard_count=4, replica_count=2)
    m.assign_all(["a", "b", "c"])
    data = DictDataAccess(m)
    for i in range(100):
        d = {"id": f"doc-{i}", "updated_at": i}
        info = m.nodes_for_key(d["id"])
        for nid in info.all_nodes():
            data.push_docs(nid, [d])
    mgr = ShardManager(m, data)
    fo = FailoverManager(mgr, healthy_nodes_fn=lambda: ["b", "c"], replica_count=2)
    fo.enqueue_failure("a")
    tasks = fo.run_pending()
    assert tasks and all(t.done for t in tasks)
    # no shard has 'a' anywhere anymore
    for info in m.shards.values():
        assert "a" not in info.all_nodes()
        assert info.primary_node in ("b", "c")
    kinds = {t.kind for t in tasks}
    assert RecoveryKind.PRIMARY_FAILOVER in kinds


# -- load balancer -----------------------------------------------------------------


def lb_with_nodes(strategy, n=4):
    lb = IntelligentLoadBalancer(LoadBalancerConfig(strategy=strategy))
    for i in range(n):
        lb.add_node(NodeInfo(node_id=f"n{i}", address=f"h{i}:1"))
    return lb


def test_lb_round_robin_exact_split():
    lb = lb_with_nodes("round_robin", n=2)
    picks = [lb.route_request()[0] for _ in range(10)]
    assert picks.count("n0") == 5 and picks.count("n1") == 5  # load_balancer.rs:587-665


def test_lb_least_connections():
    lb = lb_with_nodes("least_connections", n=3)
    lb.on_request_start("n0"); lb.on_request_start("n0"); lb.on_request_start("n1")
    assert lb.route_request()[0] == "n2"


def test_lb_skips_failed_nodes_and_weight_update():
    lb = lb_with_nodes("load_based", n=3)
    lb.set_node_state("n0", NodeState.FAILED)
    picks = {lb.route_request()[0] for _ in range(10)}
    assert "n0" not in picks
    for _ in range(20):  # EMA converges toward 2000ms -> weight ~ 1000/2100
        lb.on_request_start("n1")
        lb.on_request_end("n1", response_ms=2000.0, success=True)
    stats = lb.stats()
    assert stats["n1"]["weight"] < 0.6
    assert stats["n1"]["weight"] >= 0.1  # clamp floor


def test_lb_no_healthy_nodes():
    lb = lb_with_nodes("round_robin", n=1)
    lb.set_node_state("n0", NodeState.FAILED)
    with pytest.raises(UnavailableError):
        lb.route_request()


def test_lb_balance_report():
    lb = lb_with_nodes("round_robin", n=2)
    for _ in range(20):
        nid = lb.route_request()[0]
        lb.on_request_start(nid)
        lb.on_request_end(nid, 10.0, True)
    rep = lb.balance_report()
    assert rep.balanced and rep.max_deviation < 0.15


# -- request router ---------------------------------------------------------------


def test_router_failover_to_backup():
    lb = lb_with_nodes("round_robin", n=3)
    calls = []

    def send(node_id, request):
        calls.append(node_id)
        if node_id == calls[0]:  # first target always fails
            raise ConnectionError("down")
        return f"ok-from-{node_id}"

    router = ClusterAwareRequestRouter(lb, send)
    out = router.execute({"q": 1})
    assert out.startswith("ok-from-")
    m = router.get_metrics()
    assert m.success == 1 and m.failovers == 1


def test_router_cache_and_all_fail():
    lb = lb_with_nodes("round_robin", n=2)
    count = {"n": 0}

    def send(node_id, request):
        count["n"] += 1
        return count["n"]

    router = ClusterAwareRequestRouter(lb, send)
    a = router.execute("req", cache_key="k1")
    b = router.execute("req", cache_key="k1")
    assert a == b and count["n"] == 1
    assert router.get_metrics().cache_hits == 1

    def always_fail(node_id, request):
        raise ConnectionError("nope")

    router2 = ClusterAwareRequestRouter(lb, always_fail)
    with pytest.raises(UnavailableError):
        router2.execute("req")
    assert router2.get_metrics().failed == 1


def test_apply_placement_for_failure_deterministic_and_targeted():
    """Placement repair must be a pure function of
    replicated state (safe on every raft applier) and hand back targeted
    resync tasks for the leader's background worker — no RPCs inline."""
    m = ShardMap(shard_count=4, replica_count=2)
    m.assign_all(["a", "b", "c"])
    data = DictDataAccess(m)
    mgr = ShardManager(m, data)
    fo = FailoverManager(mgr, healthy_nodes_fn=lambda: ["b", "c"], replica_count=2)

    m2 = ShardMap(shard_count=4, replica_count=2)
    m2.assign_all(["a", "b", "c"])

    tasks = fo.apply_placement_for_failure("a", healthy=["b", "c"])
    # no shard references the failed node anywhere
    for info in m.shards.values():
        assert "a" not in info.all_nodes()
        assert info.primary_node in ("b", "c")
        # regression: shards where "a" was PRIMARY must be topped back up
        # too (promotion removes "a" from the shard, so a post-promotion
        # shards_on_node pass used to skip them -> permanent
        # under-replication)
        assert len(set(info.all_nodes())) == 2, info
    # resync tasks target exactly the freshly added replicas
    for t in tasks:
        assert t.kind == RecoveryKind.DATA_RESYNC and t.targets
        info = m.shards[t.shard_id]
        for tgt in t.targets:
            assert tgt in info.all_nodes()
    # determinism: a second applier with identical replicated state converges
    # on the identical map
    mgr2 = ShardManager(m2, DictDataAccess(m2))
    fo2 = FailoverManager(mgr2, healthy_nodes_fn=lambda: ["b", "c"], replica_count=2)
    fo2.apply_placement_for_failure("a", healthy=["b", "c"])
    for sid in m.shards:
        assert m.shards[sid].primary_node == m2.shards[sid].primary_node
        assert m.shards[sid].replica_nodes == m2.shards[sid].replica_nodes


def test_failed_primary_only_shard_elects_new_primary_and_recovers():
    """Regression: a shard whose dead primary had no replicas kept the dead
    node as primary (promote_replica returns None), so the queued resync
    pulled from the dead node on every recovery cycle and writes kept
    routing at it. Now a healthy node becomes the (empty) new primary and
    recovery pulls skip the dead source."""
    m = ShardMap(shard_count=4, replica_count=1)
    m.assign_all(["a", "b", "c"])  # replica_count=1 -> primary-only shards
    data = DictDataAccess(m)
    mgr = ShardManager(m, data)
    fo = FailoverManager(mgr, healthy_nodes_fn=lambda: ["b", "c"],
                         replica_count=1)

    tasks = fo.apply_placement_for_failure("a", healthy=["b", "c"])
    for info in m.shards.values():
        assert info.primary_node in ("b", "c"), info
        assert "a" not in info.all_nodes()
    # the recovery tasks must complete without error against the new owners
    fo.enqueue_tasks(tasks)
    done = fo.run_pending()
    assert all(not (t.result or "").startswith("error:") for t in done), \
        [t.result for t in done]


def test_lb_staleness_never_corrupts_the_shared_membership_view():
    """sweep_stale's SUSPECTED is an LB-local routing hint. When the caller
    registers the raft-replicated membership NodeInfo, the sweep must not
    mutate it (regression: the shared object let every node's OWN entry go
    stale-SUSPECTED after stale_after_s — a node never heartbeats itself —
    and cluster_health reported a permanently degraded cluster once uptime
    crossed 60 s; exposed by a slow cluster smoke run)."""
    from grape_vector_db_tpu.distributed.types import NodeInfo, NodeState

    lb = IntelligentLoadBalancer(LoadBalancerConfig(stale_after_s=0.01))
    member = NodeInfo(node_id="n0", address="x")
    lb.add_node(member)
    time.sleep(0.05)
    assert lb.sweep_stale() == ["n0"]
    # LB view suspected, membership view untouched
    assert member.state == NodeState.HEALTHY
    # explicit membership transitions still reach the LB
    lb.set_node_state("n0", NodeState.FAILED)
    assert member.state == NodeState.HEALTHY
