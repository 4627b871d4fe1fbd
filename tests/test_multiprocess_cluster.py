"""THE deployment test: a 3-node cluster as three OS processes talking over
real gRPC sockets — `cli serve --node-id --peers` end to end (the topology the
reference's stubs never reached).

The members run on the CPU here. On GPUs the cluster runs one process per
card; members that share one card must each get a share of its memory
through ``XLA_PYTHON_CLIENT_MEM_FRACTION`` (a JAX process reserves most of
the card when it starts)."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from grape_vector_db_tpu.server.grpc_server import VectorDbClient
from grape_vector_db_tpu.server.proto import vector_db_pb2 as pb


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_three_process_cluster(tmp_path):
    ports = {f"n{i}": _free_port() for i in range(3)}
    peers = ",".join(f"{nid}=127.0.0.1:{p}" for nid, p in ports.items())
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")

    procs = []
    try:
        for nid in ports:
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import jax; jax.config.update('jax_platforms','cpu');"
                 "from grape_vector_db_tpu.cli import main;"
                 f"main(['serve','--host','127.0.0.1','--rest-port','0',"
                 f"'--node-id',{nid!r},'--peers',{peers!r},"
                 f"'--shard-count','4','--replica-count','2',"
                 f"'--data-dir',{str(tmp_path / nid)!r},"
                 "'--config','/dev/null'])"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        # wait for all three banners
        for p in procs:
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                line = p.stdout.readline()
                if "serving:" in line:
                    break
            else:
                pytest.fail("node never served")

        clients = {nid: VectorDbClient(f"127.0.0.1:{p}") for nid, p in ports.items()}
        # membership converges across processes
        deadline = time.monotonic() + 60
        ok = False
        while time.monotonic() < deadline:
            infos = [c.call("GetClusterInfo", pb.GetClusterInfoRequest(),
                            timeout_s=5) for c in clients.values()]
            if all(len(i.members) == 3 for i in infos) and any(
                i.leader_id for i in infos
            ):
                ok = True
                break
            time.sleep(0.3)
        assert ok, "cluster membership never converged across processes"

        # cluster-routed write on n0, scatter-gather read on n2
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((20, 768)).astype(float)
        resp = clients["n0"].upsert_points([
            pb.Point(id=f"mp{i}", vector=pb.Vector(values=vecs[i]))
            for i in range(20)
        ])
        assert resp.upserted == 20, resp.error
        # bounded retry: the upsert ack covers the coordinator + sync
        # replicas; an async replica chosen by scatter-gather may lag the
        # write by a beat under CI load
        deadline = time.monotonic() + 10
        while True:
            sr = clients["n2"].search(list(vecs[7]), limit=3)
            assert not sr.error
            if sr.results and sr.results[0].id == "mp7":
                break
            if time.monotonic() > deadline:
                pytest.fail(f"mp7 never surfaced: {sr.results[:3]}")
            time.sleep(0.3)
        assert sr.results[0].score > 0.99
        for c in clients.values():
            c.close()
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def test_runtime_join_fourth_process(tmp_path):
    """Runtime membership over the production transport: a FOURTH OS process
    joins a live 3-process gRPC cluster — raft voter sets grow through the
    JoinCluster path, the joiner backfills, and it serves reads."""
    ports = {f"n{i}": _free_port() for i in range(3)}
    peers3 = ",".join(f"{nid}=127.0.0.1:{p}" for nid, p in ports.items())
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")

    def launch(nid, peers):
        return subprocess.Popen(
            [sys.executable, "-c",
             "import jax; jax.config.update('jax_platforms','cpu');"
             "from grape_vector_db_tpu.cli import main;"
             f"main(['serve','--host','127.0.0.1','--rest-port','0',"
             f"'--node-id',{nid!r},'--peers',{peers!r},"
             f"'--shard-count','4','--replica-count','2',"
             f"'--data-dir',{str(tmp_path / nid)!r},"
             "'--config','/dev/null'])"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )

    procs = [launch(nid, peers3) for nid in ports]
    try:
        for p in procs:
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                if "serving:" in p.stdout.readline():
                    break
            else:
                pytest.fail("node never served")

        clients = {nid: VectorDbClient(f"127.0.0.1:{p}")
                   for nid, p in ports.items()}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            infos = [c.call("GetClusterInfo", pb.GetClusterInfoRequest(),
                            timeout_s=5) for c in clients.values()]
            if all(len(i.members) == 3 for i in infos) and any(
                i.leader_id for i in infos
            ):
                break
            time.sleep(0.3)

        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((20, 768)).astype(float)
        resp = clients["n0"].upsert_points([
            pb.Point(id=f"rj{i}", vector=pb.Vector(values=vecs[i]))
            for i in range(20)
        ])
        assert resp.upserted == 20, resp.error

        # launch the runtime joiner: its peer list = seeds + itself
        ports["n3"] = _free_port()
        peers4 = ",".join(f"{nid}=127.0.0.1:{p}" for nid, p in ports.items())
        p4 = launch("n3", peers4)
        procs.append(p4)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            if "serving:" in p4.stdout.readline():
                break
        else:
            pytest.fail("joiner never served")

        clients["n3"] = VectorDbClient(f"127.0.0.1:{ports['n3']}")
        # every process converges on 4 members
        deadline = time.monotonic() + 60
        ok = False
        while time.monotonic() < deadline:
            try:
                infos = [c.call("GetClusterInfo", pb.GetClusterInfoRequest(),
                                timeout_s=5) for c in clients.values()]
                if all(len(i.members) == 4 for i in infos):
                    ok = True
                    break
            except Exception:
                pass
            time.sleep(0.3)
        assert ok, "4-node membership never converged"

        # the joiner serves scatter-gather reads of pre-join data
        deadline = time.monotonic() + 20
        while True:
            sr = clients["n3"].search(list(vecs[7]), limit=3)
            if not sr.error and sr.results and sr.results[0].id == "rj7":
                break
            if time.monotonic() > deadline:
                pytest.fail(f"joiner search never converged: {sr.results[:3]}")
            time.sleep(0.5)
        assert sr.results[0].score > 0.99

        # runtime REMOVAL over the wire: LeaveCluster shrinks the voter
        # sets and membership back to 3 on every surviving process
        resp = clients["n0"].call(
            "LeaveCluster", pb.LeaveClusterRequest(node_id="n3"),
            timeout_s=30)
        assert resp.ok
        deadline = time.monotonic() + 60
        ok = False
        while time.monotonic() < deadline:
            try:
                infos = [clients[n].call("GetClusterInfo",
                                         pb.GetClusterInfoRequest(),
                                         timeout_s=5)
                         for n in ("n0", "n1", "n2")]
                if all(
                    all(m.node_id != "n3" or m.state == "failed"
                        for m in i.members)
                    for i in infos
                ):
                    ok = True
                    break
            except Exception:
                pass
            time.sleep(0.5)
        assert ok, "n3 never left the survivors' live membership"
        # survivors still serve reads after the removal
        sr = clients["n0"].search(list(vecs[7]), limit=3)
        assert not sr.error and sr.results and sr.results[0].id == "rj7"
        for c in clients.values():
            c.close()
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
