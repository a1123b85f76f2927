"""The port's raft (master/consensus.py) against the reference's.

Three layers:

  * every case of tests/test_consensus.py and of
    tests/test_master_failover.py::TestElectionSafety, run on the port:
    the RaftNode-level ones on both packages (parametrised) and also
    answer for answer against each other, the live ones on port masters
    with ``device="cpu"`` volume servers;
  * one seeded sequence of votes, appends, conflicts, compactions and a
    snapshot install fed to both packages' RaftNode leaves byte-equal
    ``raft_log.jsonl``, ``raft_snapshot.json`` and ``raft_state.json``;
  * a master started on the other package's ``-mdir`` recovers the same
    term, vote, log span, commit, ``max_volume_id``, journal and repair
    records as one of its own package.
"""

from __future__ import annotations

import os
import random
import shutil
import time

import pytest

from seaweedfs_tpu.master import consensus as ref_consensus
from seaweedfs_tpu.master.server import MasterServer as RefMasterServer
from seaweedfs_tpu_torch.master import consensus
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port

RAFT = {"port": consensus.RaftNode, "reference": ref_consensus.RaftNode}
MASTERS = {"port": MasterServer, "reference": RefMasterServer}
FILES = ("raft_log.jsonl", "raft_snapshot.json", "raft_state.json")


@pytest.fixture(params=sorted(RAFT))
def raft_cls(request):
    return RAFT[request.param]


def wait_one_leader(masters, timeout=10.0):
    """One leader, and every other master names it."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        leaders = [m for m in masters if m.is_leader]
        if len(leaders) == 1:
            others = [m for m in masters if m is not leaders[0]]
            if all(o.leader_url == leaders[0].url for o in others):
                return leaders[0]
        time.sleep(0.1)
    raise AssertionError(
        f"no stable leader; roles={[m.raft.role for m in masters]}")


def start_trio(tmp_path, cls=MasterServer, **kw) -> list:
    ports = [free_port() for _ in range(3)]
    urls = [f"127.0.0.1:{p}" for p in ports]
    return [cls(port=p, peers=[u for j, u in enumerate(urls) if j != i],
                mdir=str(tmp_path / f"m{i}"), pulse_seconds=0.3,
                **kw).start()
            for i, p in enumerate(ports)]


@pytest.fixture
def trio(tmp_path):
    masters = start_trio(tmp_path)
    yield masters
    for m in masters:
        m.stop()


def test_constants_are_the_references():
    assert consensus.HEARTBEAT_INTERVAL == \
        ref_consensus.HEARTBEAT_INTERVAL == 0.4
    assert consensus.ELECTION_TIMEOUT == \
        ref_consensus.ELECTION_TIMEOUT == (1.2, 2.4)
    assert consensus.SNAPSHOT_THRESHOLD == \
        ref_consensus.SNAPSHOT_THRESHOLD == 512


# --- tests/test_consensus.py, on port masters ------------------------------

def test_single_node_is_immediate_leader():
    m = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    try:
        assert m.is_leader
        r = http_json("GET", f"http://{m.url}/cluster/status")
        assert r["IsLeader"] is True and r["Leader"] == m.url
        assert r["Peers"] == [] and r["Role"] == "leader"
    finally:
        m.stop()


def test_trio_elects_exactly_one_leader(trio):
    leader = wait_one_leader(trio)
    status = http_json("GET", f"http://{leader.url}/cluster/status")
    assert status["IsLeader"] and len(status["Peers"]) == 2
    assert status["Role"] == "leader" and status["Term"] >= 1
    for m in trio:
        if m is not leader:
            s = http_json("GET", f"http://{m.url}/cluster/status")
            assert s["IsLeader"] is False and s["Role"] == "follower"
            assert s["Leader"] == leader.url
            assert s["Term"] == status["Term"]


def test_follower_redirects_control_plane(trio):
    leader = wait_one_leader(trio)
    follower = next(m for m in trio if m is not leader)
    status, _, headers = http_bytes(
        "GET", f"http://{follower.url}/vol/grow?count=1",
        follow_redirects=False)
    assert status == 307
    assert headers.get("Location") == \
        f"http://{leader.url}/vol/grow?count=1"
    # a client follows the 307 to the leader
    r = http_json("GET", f"http://{follower.url}/vol/vacuum")
    assert r["compacted"] == []


def test_failover_and_state_survives(trio, tmp_path):
    leader = wait_one_leader(trio)
    d = tmp_path / "vs"
    d.mkdir()
    vs = VolumeServer([str(d)], ",".join(m.url for m in trio),
                      port=free_port(), pulse_seconds=0.3,
                      device="cpu").start()
    try:
        deadline = time.time() + 8
        while time.time() < deadline and len(leader.topo.all_nodes()) < 1:
            time.sleep(0.1)
        assert len(leader.topo.all_nodes()) == 1
        grown = http_json("GET",
                          f"http://{leader.url}/vol/grow?count=2")["volumeIds"]
        followers = [m for m in trio if m is not leader]
        deadline = time.time() + 5
        while time.time() < deadline and not all(
                f.topo.max_volume_id >= max(grown) for f in followers):
            time.sleep(0.1)
        assert all(f.topo.max_volume_id >= max(grown) for f in followers)
        leader.stop()
        new_leader = wait_one_leader(followers, timeout=15)
        assert new_leader is not leader
        # the volume server re-targets its heartbeats and re-registers
        deadline = time.time() + 10
        while time.time() < deadline and \
                len(new_leader.topo.all_nodes()) < 1:
            time.sleep(0.2)
        assert len(new_leader.topo.all_nodes()) == 1
        r2 = http_json("GET", f"http://{new_leader.url}/vol/grow?count=1")
        assert r2["volumeIds"][0] > max(grown)
    finally:
        vs.stop()


def test_raft_state_persists_across_restart(tmp_path):
    mdir = str(tmp_path / "m")
    m = MasterServer(port=free_port(), mdir=mdir, pulse_seconds=0.3).start()
    http_json("GET", f"http://{m.url}/vol/grow?count=0")
    with m.topo.lock:
        m.topo.max_volume_id = 41
    with m.raft.lock:
        m.raft.persist()
    m.stop()
    m2 = MasterServer(port=free_port(), mdir=mdir, pulse_seconds=0.3)
    assert m2.topo.max_volume_id >= 41


def test_grow_fails_closed_when_quorum_commit_fails(tmp_path):
    m = MasterServer(port=free_port(), pulse_seconds=0.3).start()
    d = tmp_path / "vs"
    d.mkdir()
    vs = VolumeServer([str(d)], m.url, port=free_port(), pulse_seconds=0.3,
                      device="cpu").start()
    try:
        deadline = time.time() + 8
        while time.time() < deadline and len(m.topo.all_nodes()) < 1:
            time.sleep(0.1)
        calls = []
        m._allocate_rpc = lambda *a, **k: calls.append(a)
        m.raft.commit_state = lambda: False  # no quorum
        status, _, _ = http_bytes("GET", f"http://{m.url}/vol/grow?count=1",
                                  follow_redirects=False)
        assert status == 500
        assert calls == [], "allocate call made before the failed commit"
    finally:
        vs.stop()
        m.stop()


def test_vote_denied_to_stale_candidate(raft_cls):
    state = {"max_volume_id": 5, "max_file_key": 100}
    voter = raft_cls("127.0.0.1:1", ["127.0.0.1:2"],
                     read_state=lambda: dict(state))
    r = voter.handle_vote(7, "127.0.0.1:2",
                          {"max_volume_id": 4, "max_file_key": 100})
    assert r["granted"] is False and voter.term == 7
    r = voter.handle_vote(8, "127.0.0.1:2",
                          {"max_volume_id": 5, "max_file_key": 100})
    assert r["granted"] is True
    voter2 = raft_cls("127.0.0.1:3", ["127.0.0.1:4"],
                      read_state=lambda: dict(state))
    assert voter2.handle_vote(3, "127.0.0.1:4")["granted"] is True


# --- TestElectionSafety, on both packages ----------------------------------

def _voter(cls, me="127.0.0.1:9001",
           peers=("127.0.0.1:9002", "127.0.0.1:9003")):
    return cls(me, list(peers), read_state=lambda: {})


def _entry(index: int, term: int) -> dict:
    return {"index": index, "term": term, "kind": "event", "data": {}}


def _random_rpcs(node, seed: int = 0x5AFE, n: int = 300) -> list:
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        term = rng.randrange(0, 40)
        if rng.random() < 0.5:
            r = node.handle_vote(
                term, rng.choice(["127.0.0.1:9002", "127.0.0.1:9003"]),
                None, rng.randrange(0, 4), rng.randrange(0, 4))
        else:
            r = node.handle_append(term, "127.0.0.1:9002", state=None,
                                   prev_index=0, prev_term=0, entries=[],
                                   commit=0)
        out.append((dict(r), node.term))
    return out


class TestElectionSafety:
    def test_term_monotonic_under_random_rpcs(self, raft_cls):
        prev = 0
        for r, term in _random_rpcs(_voter(raft_cls)):
            assert r["term"] >= prev and term >= prev
            assert r["term"] == term
            prev = term

    def test_random_rpcs_answer_as_the_reference(self):
        assert _random_rpcs(_voter(consensus.RaftNode)) == \
            _random_rpcs(_voter(ref_consensus.RaftNode))

    def test_single_vote_per_term(self, raft_cls):
        node = _voter(raft_cls)
        assert node.handle_vote(4, "127.0.0.1:9002")["granted"] is True
        assert node.handle_vote(4, "127.0.0.1:9003")["granted"] is False
        assert node.handle_vote(4, "127.0.0.1:9002")["granted"] is True
        r = node.handle_vote(3, "127.0.0.1:9003")
        assert r["granted"] is False and r["term"] == 4

    def test_stale_term_append_rejected(self, raft_cls):
        node = _voter(raft_cls)
        r = node.handle_append(5, "127.0.0.1:9002", prev_index=0,
                               prev_term=0, entries=[_entry(1, 5)],
                               commit=1)
        assert r["ok"] is True
        assert node.term == 5 and node.leader == "127.0.0.1:9002"
        stale = node.handle_append(3, "127.0.0.1:9003", prev_index=1,
                                   prev_term=3, entries=[_entry(2, 3)],
                                   commit=2)
        assert stale["ok"] is False and stale["term"] == 5
        assert node.leader == "127.0.0.1:9002"
        assert node.log.last_index == 1 and node.commit_index == 1

    def test_vote_denied_to_candidate_with_stale_log(self, raft_cls):
        node = _voter(raft_cls)
        node.handle_append(2, "127.0.0.1:9002", prev_index=0, prev_term=0,
                           entries=[_entry(1, 2), _entry(2, 2)], commit=2)
        assert node.handle_vote(5, "127.0.0.1:9003",
                                None, 9, 1)["granted"] is False
        assert node.handle_vote(6, "127.0.0.1:9003",
                                None, 1, 2)["granted"] is False
        assert node.handle_vote(7, "127.0.0.1:9003",
                                None, 2, 2)["granted"] is True

    def test_split_vote_recampaigns_with_fresh_term(self, raft_cls):
        node = raft_cls("127.0.0.1:9201",
                        [f"127.0.0.1:{free_port()}",
                         f"127.0.0.1:{free_port()}"],
                        read_state=lambda: {})
        t0 = node.term
        node._campaign()  # both peers unreachable: its own vote only
        assert node.role == "candidate" and node.term == t0 + 1
        node._campaign()
        assert node.role == "candidate" and node.term == t0 + 2
        assert node.voted_for == node.me

    def test_at_most_one_leader_per_term_randomized(self, raft_cls):
        rng = random.Random(0xE1EC7)
        names = [f"127.0.0.1:{9100 + i}" for i in range(5)]
        voters = {n: raft_cls(n, [p for p in names if p != n],
                              read_state=lambda: {})
                  for n in names}
        quorum = len(names) // 2 + 1
        winners: dict[int, set] = {}
        for _ in range(400):
            term = rng.randrange(1, 30)
            cand = rng.choice(names)
            granted = sum(
                1 for v in voters.values()
                if v.handle_vote(term, cand, None, 0, 0)["granted"])
            if granted >= quorum:
                winners.setdefault(term, set()).add(cand)
        assert winners, "no term ever reached quorum: the test is inert"
        for term, who in winners.items():
            assert len(who) == 1, f"two leaders in term {term}: {who}"


# --- the durable files, byte for byte --------------------------------------

def _drive(cls, state_dir: str) -> dict:
    """A seeded follower history, then a leader's and a snapshot install,
    on one node; -> its status."""
    rng = random.Random(0x10C)
    meta = {"max_volume_id": 0, "max_file_key": 0}
    applied: list = []

    def apply_state(s: dict) -> None:
        for k in meta:
            meta[k] = max(meta[k], int(s.get(k, 0)))

    def apply_entry(kind: str, data: dict) -> None:
        applied.append(kind)
        if kind == "vid_alloc":
            apply_state(data)

    node = cls("127.0.0.1:9001", ["127.0.0.1:9002", "127.0.0.1:9003"],
               state_dir=state_dir, apply_state=apply_state,
               read_state=lambda: dict(meta), apply_entry=apply_entry,
               read_snapshot=lambda: {"meta": dict(meta),
                                      "applied": len(applied)},
               apply_snapshot=lambda s: apply_state(s.get("meta") or {}),
               snapshot_threshold=8)

    def entries(first: int, n: int, term: int) -> list:
        out = []
        for i in range(first, first + n):
            kind = rng.choice(["vid_alloc", "event", "coordinator",
                               "alert"])
            data = ({"max_volume_id": rng.randrange(1, 99),
                     "max_file_key": rng.randrange(1, 9999)}
                    if kind == "vid_alloc" else
                    {"events": [{"id": f"e{i}", "ts": i / 10}]}
                    if kind == "event" else
                    {"id": f"{i}:planned:1.000", "op": "planned", "vid": i}
                    if kind == "coordinator" else
                    {"alerts": {"peer_down": {"state": "firing"}}})
            out.append({"index": i, "term": term, "kind": kind,
                        "data": data})
        return out

    assert node.handle_vote(1, "127.0.0.1:9002", dict(meta), 0, 0)["granted"]
    node.handle_append(1, "127.0.0.1:9002", dict(meta), prev_index=0,
                       prev_term=0, entries=entries(1, 6, 1), commit=3)
    node.handle_append(1, "127.0.0.1:9002", {"max_volume_id": 7},
                       prev_index=6, prev_term=1, entries=entries(7, 5, 1),
                       commit=9)
    # a new leader of term 2 overwrites the uncommitted tail from 10
    node.handle_vote(2, "127.0.0.1:9003", {"max_volume_id": 99,
                                           "max_file_key": 99999}, 11, 1)
    node.handle_append(2, "127.0.0.1:9003", None, prev_index=10,
                       prev_term=2, entries=[], commit=9)
    node.handle_append(2, "127.0.0.1:9003", None, prev_index=9,
                       prev_term=1, entries=entries(10, 6, 2), commit=14)
    node._maybe_compact()  # 14 committed, past the threshold of 8
    # promoted in term 3: the leader's own appends, then compaction
    with node.lock:
        node.term, node.role, node.leader = 3, "leader", node.me
        node.commit_index = node.log.last_index
    for e in entries(16, 8, 3):
        node.append(e["kind"], e["data"])
    with node.lock:
        node.commit_index = node.log.last_index
    node._apply_committed()
    node._maybe_compact()
    # deposed; a lagging install of a later leader's image and tail
    node.handle_snapshot(5, "127.0.0.1:9002", 30, 4,
                         {"meta": {"max_volume_id": 120,
                                   "max_file_key": 12345}},
                         entries=entries(31, 3, 5), commit=32)
    node.handle_vote(6, "127.0.0.1:9003", None, 33, 5)
    node.stop()
    return node.status()


def test_durable_files_equal_the_references(tmp_path):
    got = _drive(consensus.RaftNode, str(tmp_path / "port"))
    want = _drive(ref_consensus.RaftNode, str(tmp_path / "ref"))
    assert got == want
    assert want["snapshot_index"] == 30 and want["last_index"] == 33
    assert want["snapshots_installed"] == 1
    for name in FILES:
        with open(tmp_path / "port" / name, "rb") as f:
            mine = f.read()
        with open(tmp_path / "ref" / name, "rb") as f:
            theirs = f.read()
        assert mine and mine == theirs, name


# --- state carried across packages -----------------------------------------

def _fill(masters) -> None:
    """Journal batches, a repair record and a volume-id commit through the
    leader of a running trio."""
    leader = wait_one_leader(masters)
    for m in masters:
        m._event_shipper.detach()  # only the POSTs below fill the journal
    for i in range(12):
        http_json("POST", f"http://{leader.url}/cluster/events/ingest",
                  {"server": "drill", "events": [{
                      "id": f"mdir-{i}", "type": "drill_marker",
                      "severity": "info", "server": "drill",
                      "ts": 1000.0 + i, "details": {"i": i}}]})
    rec = {"id": "77:planned:1.000", "op": "planned", "vid": 77, "at": 1.0,
           "alert": "scrub_unrepairable", "cause_trace": "ab" * 16,
           "cause_event": "mdir-0"}
    leader.coordinator.apply_replicated(rec)
    leader._replicate_coordinator_record(rec)
    with leader.topo.lock:
        leader.topo.max_volume_id = 23
    assert leader.raft.commit_state()
    deadline = time.time() + 10
    while time.time() < deadline and not all(
            m.raft.commit_index == leader.raft.log.last_index
            for m in masters):
        time.sleep(0.1)


def _recovered(cls, mdir: str, peers: list) -> dict:
    m = cls(port=free_port(), peers=peers, mdir=mdir, pulse_seconds=0.3)
    r = m.raft
    return {"term": r.term, "voted_for": r.voted_for,
            "log": (r.log.base_index, r.log.last_index, r.log.last_term),
            "commit": r.commit_index, "applied": r.last_applied,
            "max_volume_id": m.topo.max_volume_id,
            "events": sorted(e["id"] for e in m.event_journal.query(limit=0)
                             if e["id"].startswith("mdir-")),
            "pending": m.coordinator.export_replicated()["pending"]}


@pytest.mark.parametrize("writer", sorted(MASTERS))
def test_a_master_recovers_the_other_package_s_mdir(tmp_path, writer):
    masters = start_trio(tmp_path / "run", cls=MASTERS[writer])
    try:
        _fill(masters)
    finally:
        for m in masters:
            m.stop()
    time.sleep(0.3)
    peers = ["127.0.0.1:1", "127.0.0.1:2"]  # never started
    got = {}
    for reader in sorted(MASTERS):
        copy = str(tmp_path / f"read-{reader}")
        shutil.copytree(str(tmp_path / "run" / "m0"), copy)
        got[reader] = _recovered(MASTERS[reader], copy, peers)
    assert got["port"] == got["reference"]
    assert got["port"]["max_volume_id"] == 23
    assert got["port"]["events"] == sorted(f"mdir-{i}" for i in range(12))
    assert got["port"]["pending"]["77"]["cause_trace"] == "ab" * 16
    assert got["port"]["log"][1] > 12 and got["port"]["term"] >= 1
    assert os.path.exists(tmp_path / "run" / "m0" / "raft_log.jsonl")
