"""Multi-master consensus: raft leader election and a replicated log.

The port's copy of seaweedfs_tpu/master/consensus.py (the reference's
weed/server/raft_server.go and the chrislusf/raft dependency).  The log
carries the control plane's replicated state:

  * typed, monotonically indexed entries ``{"index", "term", "kind",
    "data"}`` (the port's kinds: vid_alloc, event, alert, coordinator,
    ec_registry, and the new leader's noop) appended by the leader and
    replicated to followers on the heartbeat cadence
    (``append(kind, data)``) or to a quorum before the call returns
    (``append(..., sync=True)``);
  * follower apply loops: committed entries flow through
    ``apply_entry(kind, data)`` into the same state machines the leader
    runs, so a follower is a warm standby, not a blank one;
  * snapshot and truncate: once the committed span passes
    ``snapshot_threshold`` the whole state machine image
    (``read_snapshot()``) replaces the prefix;
  * InstallSnapshot catch-up: a restarted or long-partitioned follower
    whose needed entries were compacted away receives the snapshot and
    the remaining tail in one ``/raft/snapshot`` call.

Durable state lives under ``state_dir`` (the master's ``-mdir``):
``raft_log.jsonl`` (one entry a line), ``raft_snapshot.json`` and
``raft_state.json`` (term, vote, commit and the meta counters), written
as the reference writes them, so either package's master recovers the
other's directory.

Leaders apply their own entries at APPEND time (their state machines are
the source of the mutation); followers apply at COMMIT time.  The apply
and snapshot callbacks must therefore be idempotent: the journals dedup
by record id and the volume-id counters max-merge, so replays across a
snapshot and entry overlap are harmless.

Followers redirect control-plane calls to the leader; volume servers
re-target their heartbeats on a follower's answer.  A single node (no
peers) is the leader at once and commits locally.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Callable, Optional

from ..utils.httpd import http_json

HEARTBEAT_INTERVAL = 0.4
ELECTION_TIMEOUT = (1.2, 2.4)
# committed entries beyond this span trigger snapshot+truncate
SNAPSHOT_THRESHOLD = 512


class RaftLog:
    """Ordered entry log above a snapshot base, durable when given a
    state_dir (JSONL entries + a snapshot document).  All mutation runs
    under the owning RaftNode's lock — this class adds none of its own.
    """

    def __init__(self, state_dir: str = ""):
        self.state_dir = state_dir
        self.entries: list[dict] = []  # guarded-by: RaftNode.lock
        self.base_index = 0  # guarded-by: RaftNode.lock
        self.base_term = 0  # guarded-by: RaftNode.lock
        # the compaction-time state image (what InstallSnapshot sends)
        self.base_state: dict = {}  # guarded-by: RaftNode.lock

    # --- paths ------------------------------------------------------------
    def _log_path(self) -> str:
        return os.path.join(self.state_dir, "raft_log.jsonl")

    def _snap_path(self) -> str:
        return os.path.join(self.state_dir, "raft_snapshot.json")

    # --- durability -------------------------------------------------------
    def load(self) -> None:
        """Recover snapshot + entry tail from disk (torn trailing line
        from a crash mid-append is dropped, not fatal)."""
        if not self.state_dir:
            return
        try:
            with open(self._snap_path()) as f:
                snap = json.load(f)
            self.base_index = int(snap.get("last_index", 0))
            self.base_term = int(snap.get("last_term", 0))
            self.base_state = snap.get("state") or {}
        except (FileNotFoundError, ValueError):
            pass
        entries: list[dict] = []
        try:
            with open(self._log_path()) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        e = json.loads(line)
                    except ValueError:
                        break  # torn tail write: everything before holds
                    if e.get("index", 0) > self.base_index and \
                            (not entries
                             or e["index"] == entries[-1]["index"] + 1):
                        entries.append(e)
        except FileNotFoundError:
            pass
        self.entries = entries

    def _append_line(self, entry: dict) -> None:
        if not self.state_dir:
            return
        with open(self._log_path(), "a") as f:
            f.write(json.dumps(entry, sort_keys=True) + "\n")

    def _rewrite(self) -> None:
        """Atomic full rewrite (truncate / compact / reset paths)."""
        if not self.state_dir:
            return
        tmp = self._log_path() + ".tmp"
        with open(tmp, "w") as f:
            for e in self.entries:
                f.write(json.dumps(e, sort_keys=True) + "\n")
        os.replace(tmp, self._log_path())

    def _write_snapshot(self) -> None:
        if not self.state_dir:
            return
        tmp = self._snap_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"last_index": self.base_index,
                       "last_term": self.base_term,
                       "state": self.base_state}, f, sort_keys=True)
        os.replace(tmp, self._snap_path())

    # --- queries ----------------------------------------------------------
    @property
    def last_index(self) -> int:
        return self.entries[-1]["index"] if self.entries \
            else self.base_index

    @property
    def last_term(self) -> int:
        return self.entries[-1]["term"] if self.entries \
            else self.base_term

    def entry(self, index: int) -> Optional[dict]:
        i = index - self.base_index - 1
        return self.entries[i] if 0 <= i < len(self.entries) else None

    def term_at(self, index: int) -> int:
        if index == self.base_index:
            return self.base_term
        e = self.entry(index)
        return e["term"] if e else -1

    def entries_from(self, index: int) -> list[dict]:
        i = max(0, index - self.base_index - 1)
        return list(self.entries[i:])

    # --- mutation (all under RaftNode.lock) -------------------------------
    def append(self, term: int, kind: str, data: dict) -> dict:
        entry = {"index": self.last_index + 1, "term": term,
                 "kind": kind, "data": data}
        self.entries.append(entry)
        self._append_line(entry)
        return entry

    def truncate_from(self, index: int) -> None:
        """Drop every entry with index >= index (conflict resolution)."""
        keep = index - self.base_index - 1
        if keep < len(self.entries):
            self.entries = self.entries[:max(0, keep)]
            self._rewrite()

    def compact(self, upto: int, state: dict) -> None:
        """Snapshot+truncate: the state image replaces entries <= upto."""
        if upto <= self.base_index:
            return
        term = self.term_at(upto)
        self.entries = self.entries_from(upto + 1)
        self.base_index = upto
        self.base_term = term if term >= 0 else self.base_term
        self.base_state = state
        self._write_snapshot()
        self._rewrite()

    def reset(self, index: int, term: int, state: dict) -> None:
        """InstallSnapshot: discard the whole log for a received image."""
        self.entries = []
        self.base_index = index
        self.base_term = term
        self.base_state = state
        self._write_snapshot()
        self._rewrite()


class RaftNode:
    def __init__(self, me: str, peers: list[str], state_dir: str = "",
                 apply_state: Optional[Callable[[dict], None]] = None,
                 read_state: Optional[Callable[[], dict]] = None,
                 apply_entry: Optional[Callable[[str, dict], None]] = None,
                 read_snapshot: Optional[Callable[[], dict]] = None,
                 apply_snapshot: Optional[Callable[[dict], None]] = None,
                 snapshot_threshold: int = SNAPSHOT_THRESHOLD):
        self.me = me
        self.peers = [p for p in peers if p and p != me]
        self.state_dir = state_dir
        self.apply_state = apply_state or (lambda s: None)
        self.read_state = read_state or (lambda: {})
        self.apply_entry = apply_entry or (lambda kind, data: None)
        # full state-machine image for compaction / InstallSnapshot;
        # defaults to the small meta blob when the owner has no journals
        self.read_snapshot = read_snapshot or self.read_state
        self.apply_snapshot = apply_snapshot or self.apply_state
        self.snapshot_threshold = max(8, int(snapshot_threshold))
        self.lock = threading.RLock()
        self.term = 0
        self.voted_for: Optional[str] = None
        self.role = "follower" if self.peers else "leader"  # guarded-by: lock
        self.leader: Optional[str] = None if self.peers else me  # guarded-by: lock
        self.log = RaftLog(state_dir)
        self.commit_index = 0  # guarded-by: lock
        self.last_applied = 0  # guarded-by: lock
        # per-peer replication progress (leader-only bookkeeping)
        self._next: dict[str, int] = {}  # guarded-by: lock
        self._match: dict[str, int] = {}  # guarded-by: lock
        self._last_heard = time.time()
        # zombie-leader guard: last instant a quorum acked our append
        self._last_quorum = time.time()  # guarded-by: lock
        self._timeout = random.uniform(*ELECTION_TIMEOUT)
        self._stop = threading.Event()
        self.on_role_change: Optional[Callable[[str], None]] = None
        self._last_persisted: Optional[str] = None  # guarded-by: lock
        # serializes apply_entry delivery so entries reach the state
        # machines in index order even when HTTP router threads race
        self._apply_lock = threading.Lock()
        self.snapshots_installed = 0  # guarded-by: lock
        self.snapshots_sent = 0  # guarded-by: lock
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
            self._load()

    # --- persistence (-mdir snapshot) -------------------------------------
    def _state_path(self) -> str:
        return os.path.join(self.state_dir, "raft_state.json")

    def _load(self) -> None:
        commit = 0
        try:
            with open(self._state_path()) as f:
                d = json.load(f)
            self.term = d.get("term", 0)
            self.voted_for = d.get("voted_for")
            commit = int(d.get("commit", 0))
            if d.get("state"):
                self.apply_state(d["state"])
        except (FileNotFoundError, ValueError):
            pass
        self.log.load()
        # restart recovery: re-drive the snapshot image + the committed
        # entry tail through the owner's state machines (idempotent)
        if self.log.base_state:
            try:
                self.apply_snapshot(self.log.base_state)
            except Exception:
                pass
        self.commit_index = max(self.log.base_index,
                                min(commit, self.log.last_index))
        self.last_applied = self.log.base_index
        self._apply_committed()

    def persist(self) -> None:  # holds: lock
        if not self.state_dir:
            return
        doc = json.dumps({"term": self.term, "voted_for": self.voted_for,
                          "commit": self.commit_index,
                          "state": self.read_state()}, sort_keys=True)
        if doc == self._last_persisted:
            return  # heartbeats with unchanged state skip the disk write
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            f.write(doc)
        os.replace(tmp, self._state_path())
        self._last_persisted = doc

    # --- role helpers -----------------------------------------------------
    @property
    def is_leader(self) -> bool:
        with self.lock:
            return self.role == "leader"

    def quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    def status(self) -> dict:
        """One node's raft view (the /cluster/status + cluster.raft
        surface)."""
        with self.lock:
            return {"role": self.role, "term": self.term,
                    "leader": self.leader or "",
                    "commit_index": self.commit_index,
                    "last_applied": self.last_applied,
                    "log_length": len(self.log.entries),
                    "log_first_index": self.log.base_index + 1,
                    "last_index": self.log.last_index,
                    "snapshot_index": self.log.base_index,
                    "snapshots_installed": self.snapshots_installed,
                    "snapshots_sent": self.snapshots_sent}

    # --- RPC handlers (the /raft/* routes call these) ---------------------
    def _candidate_up_to_date(self, candidate_state: Optional[dict],
                              last_index: Optional[int] = None,
                              last_term: Optional[int] = None) -> bool:
        """Raft's election restriction: a vote goes only to candidates
        whose LOG is at least as up-to-date as ours (last term, then
        last index), plus the legacy monotonic-counter check — a node
        that missed a quorum-committed max_volume_id could otherwise
        win and re-issue ids."""
        if last_term is not None and last_index is not None:
            if last_term != self.log.last_term:
                return last_term > self.log.last_term
            if last_index < self.log.last_index:
                return False
        if candidate_state is None:
            return True  # pre-upgrade peer: preserve liveness
        mine = self.read_state()
        for key, value in mine.items():
            if isinstance(value, (int, float)) and \
                    candidate_state.get(key, 0) < value:
                return False
        return True

    def handle_vote(self, term: int, candidate: str,
                    candidate_state: Optional[dict] = None,
                    last_index: Optional[int] = None,
                    last_term: Optional[int] = None) -> dict:
        with self.lock:
            if term < self.term:
                return {"term": self.term, "granted": False}
            if term > self.term:
                self.term = term
                self.voted_for = None
                self._become_follower(None)
            granted = self.voted_for in (None, candidate) \
                and self._candidate_up_to_date(candidate_state,
                                               last_index, last_term)
            if granted:
                self.voted_for = candidate
                self._last_heard = time.time()
            self.persist()
            return {"term": self.term, "granted": granted}

    def handle_append(self, term: int, leader: str,
                      state: Optional[dict] = None,
                      prev_index: Optional[int] = None,
                      prev_term: int = 0,
                      entries: Optional[list] = None,
                      commit: Optional[int] = None) -> dict:
        with self.lock:
            if term < self.term:
                return {"term": self.term, "ok": False,
                        "last_index": self.log.last_index}
            if term > self.term:
                self.term = term
                self.voted_for = None
            self._become_follower(leader)
            self._last_heard = time.time()
            if state:
                # meta blob rides every heartbeat (cheap max-merge);
                # also the whole payload for pre-log-era callers
                self.apply_state(state)
            if prev_index is None:
                self.persist()
                return {"term": self.term, "ok": True,
                        "last_index": self.log.last_index}
            # --- log consistency check -------------------------------
            if prev_index > self.log.last_index:
                # gap: tell the leader where our log actually ends
                self.persist()
                return {"term": self.term, "ok": False,
                        "last_index": self.log.last_index,
                        "need_snapshot":
                            prev_index <= self.log.base_index}
            if prev_index >= self.log.base_index and \
                    self.log.term_at(prev_index) != prev_term:
                # conflicting history: drop our divergent tail
                self.log.truncate_from(prev_index)
                self.persist()
                return {"term": self.term, "ok": False,
                        "last_index": self.log.last_index,
                        "need_snapshot":
                            prev_index <= self.log.base_index}
            for e in (entries or []):
                idx = int(e.get("index", 0))
                if idx <= self.log.base_index:
                    continue  # already inside our snapshot
                have = self.log.entry(idx)
                if have is not None:
                    if have["term"] == e.get("term"):
                        continue  # duplicate delivery
                    self.log.truncate_from(idx)
                self.log.append(e.get("term", term), e.get("kind", ""),
                                e.get("data") or {})
                # re-stamp the authoritative index/term (append assigns
                # sequentially, which matches because the gap check
                # above guarantees contiguity)
            if commit is not None:
                self.commit_index = max(
                    self.commit_index,
                    min(int(commit), self.log.last_index))
            self.persist()
            last = self.log.last_index
        self._apply_committed()
        return {"term": self.term, "ok": True, "last_index": last}

    def handle_snapshot(self, term: int, leader: str, last_index: int,
                        last_term: int, state: dict,
                        entries: Optional[list] = None,
                        commit: Optional[int] = None) -> dict:
        """InstallSnapshot: replace our log + state machines with the
        leader's image, then append the entry tail it sent along."""
        with self.lock:
            if term < self.term:
                return {"term": self.term, "ok": False}
            if term > self.term:
                self.term = term
                self.voted_for = None
            self._become_follower(leader)
            self._last_heard = time.time()
            if last_index <= self.log.base_index:
                # stale snapshot (we already compacted past it): still
                # take the tail entries below
                pass
            else:
                self.log.reset(last_index, last_term, state)
                self.commit_index = last_index
                self.last_applied = last_index
        # the state image replays through the owner's machines OUTSIDE
        # the raft lock (journal ingest takes its own locks + hooks)
        try:
            self.apply_snapshot(state)
        except Exception:
            pass
        with self.lock:
            self.snapshots_installed += 1
            for e in (entries or []):
                idx = int(e.get("index", 0))
                if idx <= self.log.last_index:
                    continue
                self.log.append(e.get("term", term), e.get("kind", ""),
                                e.get("data") or {})
            if commit is not None:
                self.commit_index = max(
                    self.commit_index,
                    min(int(commit), self.log.last_index))
            self.persist()
            last = self.log.last_index
        self._apply_committed()
        return {"term": self.term, "ok": True, "last_index": last}

    def _become_follower(self, leader: Optional[str]) -> None:  # holds: lock
        was = self.role
        if self.role != "follower" or (leader and self.leader != leader):
            self.role = "follower"
        if leader:
            self.leader = leader
        if was != self.role:
            self._notify_role(self.role)

    def _notify_role(self, role: str) -> None:
        """Takes the just-committed role as an argument so it never
        reads shared state lock-free — callers outside the lock (the
        hook must not run under it) stay outside it."""
        if self.on_role_change is not None:
            try:
                self.on_role_change(role)
            except Exception:
                pass

    # --- the replicated log (leader write path) ---------------------------
    def append(self, kind: str, data: dict, sync: bool = False) -> bool:
        """Leader-only: append one typed entry to the replicated log.
        ``sync=True`` replicates to a quorum before returning (the
        volume-id allocation contract); otherwise the entry rides the
        next heartbeat.  The caller has ALREADY applied the mutation to
        its local state machine — leaders apply at append time."""
        if not self.peers:
            with self.lock:
                e = self.log.append(self.term, kind, data)
                self.commit_index = e["index"]
                self.last_applied = e["index"]
                self.persist()
            self._maybe_compact()
            return True
        with self.lock:
            if self.role != "leader":
                return False
            e = self.log.append(self.term, kind, data)
            idx = e["index"]
            # the caller pre-applied THIS entry, but a freshly promoted
            # leader may still hold an unapplied prior-term tail (its
            # predecessor's records, committed only once an own-term
            # entry commits).  Jumping last_applied over that gap would
            # skip those entries on this node forever; leave the gap to
            # _apply_committed, which delivers in order (re-delivering
            # this entry too — every apply branch is idempotent).
            if self.last_applied == idx - 1:
                self.last_applied = idx
        if not sync:
            return True
        acked = self._broadcast_append()
        with self.lock:
            committed = self.commit_index >= idx \
                and acked >= self.quorum()
        return committed

    def commit_state(self) -> bool:
        """Back-compat: synchronously replicate the meta state to a
        quorum — used before acking volume-id allocations, so a leader
        crash cannot let the next leader re-issue the same ids."""
        if not self.peers:
            with self.lock:
                self.persist()
            return True
        if not self.is_leader:
            return False
        return self.append("vid_alloc", self.read_state(), sync=True)

    def _apply_committed(self) -> None:
        """Deliver committed-but-unapplied entries to the state
        machines, strictly in index order, outside the main lock."""
        with self._apply_lock:
            while True:
                with self.lock:
                    if self.last_applied >= self.commit_index:
                        break
                    idx = self.last_applied + 1
                    e = self.log.entry(idx)
                    self.last_applied = idx
                if e is not None:
                    try:
                        self.apply_entry(e["kind"], e["data"])
                    except Exception:
                        pass  # one poison entry must not wedge the loop

    def _maybe_compact(self) -> None:
        """Snapshot+truncate once the committed span outgrows the
        threshold.  The image is read OUTSIDE the raft lock (journals
        take their own locks); slight staleness is fine because apply
        is idempotent."""
        with self.lock:
            upto = min(self.commit_index, self.last_applied)
            if upto - self.log.base_index < self.snapshot_threshold:
                return
        try:
            state = self.read_snapshot()
        except Exception:
            return
        with self.lock:
            upto = min(self.commit_index, self.last_applied)
            if upto > self.log.base_index:
                self.log.compact(upto, state)
                self.persist()

    # --- main loop --------------------------------------------------------
    def start(self) -> "RaftNode":
        if self.peers:
            threading.Thread(target=self._run, daemon=True,
                             name=f"raft-{self.me}").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self.lock:  # persist's contract: called with lock held
            self.persist()

    def _run(self) -> None:
        while not self._stop.is_set():
            with self.lock:
                role = self.role
                overdue = time.time() - self._last_heard > self._timeout
            if role == "leader":
                # short RPC/join budget + elapsed-aware sleep: the worst-
                # case heartbeat PERIOD must stay well under the minimum
                # election timeout, or a single dead peer makes healthy
                # followers campaign (the flapping this loop exists to
                # prevent)
                t0 = time.monotonic()
                self._broadcast_append(rpc_timeout=0.3,
                                       join_timeout=0.45)
                with self.lock:
                    # zombie-leader guard: a leader that has not heard a
                    # quorum ack for a full minimum election timeout is
                    # behind a partition where a NEW leader may already
                    # reign — demote instead of mutating state nobody
                    # will ever commit
                    starved = self.role == "leader" and \
                        time.time() - self._last_quorum > \
                        ELECTION_TIMEOUT[0]
                if starved:
                    self._step_down()
                self._maybe_compact()
                elapsed = time.monotonic() - t0
                self._stop.wait(max(0.05, HEARTBEAT_INTERVAL - elapsed))
            elif overdue:
                self._campaign()
            else:
                self._stop.wait(0.05)

    def _campaign(self) -> None:
        with self.lock:
            self.role = "candidate"
            self.term += 1
            term = self.term
            self.voted_for = self.me
            self._last_heard = time.time()
            self._timeout = random.uniform(*ELECTION_TIMEOUT)
            my_state = self.read_state()
            last_index = self.log.last_index
            last_term = self.log.last_term
            self.persist()
        results: list[dict] = []

        def ask(p: str) -> None:
            try:
                results.append(http_json(
                    "POST", f"http://{p}/raft/vote",
                    {"term": term, "candidate": self.me,
                     "state": my_state, "last_index": last_index,
                     "last_term": last_term}, timeout=1.0))
            except Exception:
                pass

        # parallel like _broadcast_append: serial 1s timeouts to dead
        # peers would outlast the election timeout and churn terms
        threads = [threading.Thread(target=ask, args=(p,), daemon=True,
                                   name=f"raft-vote:{p}")
                   for p in self.peers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(1.2)
        votes = 1
        for r in results:
            with self.lock:
                if r.get("term", 0) > self.term:
                    self.term = r["term"]
                    self._become_follower(None)
                    self.persist()
                    return
            if r.get("granted"):
                votes += 1
        won = False
        with self.lock:
            if self.role == "candidate" and self.term == term \
                    and votes >= self.quorum():
                self.role = "leader"
                self.leader = self.me
                self._last_quorum = time.time()
                # replication bookkeeping restarts at our log end —
                # followers walk us back via their reply last_index
                nxt = self.log.last_index + 1
                self._next = {p: nxt for p in self.peers}
                self._match = {p: 0 for p in self.peers}
                won = True
        if won:
            # raft's commit rule never counts prior-term entries, so a
            # dead leader's log tail (e.g. a repair's planned record
            # appended moments before the crash) would stay uncommitted
            # until organic traffic appends something.  A no-op entry in OUR term commits the whole
            # tail transitively on the first replication round.
            with self.lock:
                if self.role == "leader":
                    e = self.log.append(self.term, "noop", {})
                    if self.last_applied == e["index"] - 1:
                        self.last_applied = e["index"]
            self._notify_role("leader")
            self._broadcast_append()

    def _step_down(self) -> None:
        changed = False
        with self.lock:
            if self.role == "leader":
                self._last_heard = time.time()
                self.role = "follower"
                changed = True
        if changed:
            self._notify_role("follower")

    def _broadcast_append(self, rpc_timeout: float = 1.0,
                          join_timeout: float = 1.5) -> int:
        """One replication round: per-peer entry shipping from each
        peer's next-index (snapshot transfer when that index was
        compacted away), then commit-index advance over the quorum of
        match indexes.  Returns how many nodes (incl. us) acked."""
        with self.lock:
            term = self.term
            state = self.read_state()
            commit = self.commit_index
            plans: list[tuple[str, dict, str, int]] = []
            for p in self.peers:
                nxt = self._next.get(p, self.log.last_index + 1)
                if nxt <= self.log.base_index:
                    payload = {"term": term, "leader": self.me,
                               "last_index": self.log.base_index,
                               "last_term": self.log.base_term,
                               "state": self.log.base_state,
                               "entries": self.log.entries_from(
                                   self.log.base_index + 1),
                               "commit": commit}
                    plans.append((p, payload, "snapshot",
                                  self.log.last_index))
                else:
                    ents = self.log.entries_from(nxt)
                    payload = {"term": term, "leader": self.me,
                               "state": state,
                               "prev_index": nxt - 1,
                               "prev_term": self.log.term_at(nxt - 1),
                               "entries": ents,
                               "commit": commit}
                    plans.append((p, payload, "append",
                                  ents[-1]["index"] if ents
                                  else nxt - 1))
        results: list[tuple[str, str, int, dict]] = []

        def send(p: str, payload: dict, rpc: str, sent_last: int) -> None:
            try:
                r = http_json("POST", f"http://{p}/raft/{rpc}",
                              payload, timeout=rpc_timeout)
                results.append((p, rpc, sent_last, r))
            except Exception:
                pass

        # parallel: one dead peer must not delay the live ones past the
        # election timeout (serial 1s timeouts would cause flapping)
        threads = [threading.Thread(target=send, args=plan, daemon=True,
                                   name=f"raft-append:{plan[0]}")
                   for plan in plans]
        for t in threads:
            t.start()
        for t in threads:
            t.join(join_timeout)
        acked = 1
        for p, rpc, sent_last, r in results:
            with self.lock:
                if r.get("term", 0) > self.term:
                    self.term = r["term"]
                    self._become_follower(None)
                    self.persist()
                    return 0
                if rpc == "snapshot":
                    self.snapshots_sent += 1
                if r.get("ok"):
                    acked += 1
                    self._match[p] = max(self._match.get(p, 0),
                                         sent_last)
                    self._next[p] = self._match[p] + 1
                else:
                    # walk back toward the follower's actual log end;
                    # a next-index at/below our snapshot base flips the
                    # next round to an InstallSnapshot
                    reply_last = int(r.get("last_index", 0))
                    self._next[p] = max(
                        1, min(self._next.get(p, 1) - 1,
                               reply_last + 1))
        advanced = False
        with self.lock:
            if self.role == "leader":
                if acked >= self.quorum():
                    self._last_quorum = time.time()
                # quorum-replicated index: the quorum()-th highest match
                # (our own log end counts as a match)
                matches = sorted(
                    [self.log.last_index]
                    + [self._match.get(p, 0) for p in self.peers],
                    reverse=True)
                candidate = matches[self.quorum() - 1]
                # raft's commit rule: only entries from the CURRENT
                # term commit by counting (prior-term entries commit
                # transitively)
                if candidate > self.commit_index and \
                        self.log.term_at(candidate) == self.term:
                    self.commit_index = candidate
                    advanced = True
                self.persist()
        if advanced:
            self._apply_committed()
        return acked
