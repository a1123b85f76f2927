"""The port's EC planner and executor against the reference's.

Seeded topology documents, shaped like the master's ``/dir/status``
Topology (several data centers and racks, EC volumes with missing,
duplicated and stale-held shards), go through both packages'
``view_from_status``, ``clean_deficits``, ``placement_rank``,
``choose_rebuild_host``, ``rack_ceiling`` and ``plan_rebalance``; the
answers must be equal.  ``PlanExecutor`` runs each repair and each
planned move against a recording transport on both sides: the calls,
their order and payloads, and the results must be equal too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import seaweedfs_tpu.ops.coordinator as ref
import seaweedfs_tpu_torch.ops.coordinator as port

SEEDS = list(range(12))


def topology_doc(seed: int) -> tuple[dict, tuple]:
    """A /dir/status Topology with EC volumes; -> (doc, stale urls)."""
    rng = np.random.default_rng(seed)
    nodes = []
    dcs = []
    for d in range(int(rng.integers(1, 3))):
        racks = []
        for r in range(int(rng.integers(1, 4))):
            data_nodes = []
            for k in range(int(rng.integers(1, 4))):
                url = f"10.{d}.{r}.{k}:8080"
                nodes.append(url)
                data_nodes.append({"Url": url,
                                   "Free": int(rng.integers(-1, 6)),
                                   "EcShards": int(rng.integers(0, 20))})
            racks.append({"Id": f"rack{r}", "DataNodes": data_nodes})
        dcs.append({"Id": f"dc{d}", "Racks": racks})
    ec_volumes, collections = {}, {}
    for vid in range(1, int(rng.integers(2, 5))):
        shards = {}
        for sid in range(14):
            if rng.random() < 0.12:
                continue  # lost
            holders = list(rng.choice(nodes, size=1 + int(
                rng.random() < 0.15), replace=len(nodes) < 2))
            shards[str(sid)] = sorted(set(holders))
        ec_volumes[str(vid)] = shards
        collections[str(vid)] = ["", "ec", "pics"][vid % 3]
    stale = tuple(u for u in nodes if rng.random() < 0.15)
    return ({"DataCenters": dcs, "EcVolumes": ec_volumes,
             "EcCollections": collections}, stale)


def _view_doc(view) -> dict:
    return {"nodes": {u: dataclasses.asdict(n)
                      for u, n in view.nodes.items()},
            "shards": view.shards, "collections": view.collections}


def _moves(moves) -> list:
    return [(m.vid, m.sid, m.src, m.dst, m.kind, m.reason) for m in moves]


def _plans(mod, doc: dict, stale: tuple) -> dict:
    view = mod.view_from_status(doc, stale=stale)
    out = {"view": _view_doc(view), "deficits": mod.clean_deficits(view),
           "ceiling": mod.rack_ceiling(view), "racks": sorted(view.racks())}
    for vid in sorted(view.shards):
        out[f"host {vid}"] = mod.choose_rebuild_host(view, vid)
        out[f"present {vid}"] = sorted(view.present_shards(vid))
        out[f"racks {vid}"] = sorted(view.rack_counts(vid).items())
        for sid in range(14):
            out[f"rank {vid}.{sid}"] = mod.placement_rank(view, vid, sid)
    for budget in (0, 1, 3):
        out[f"plan {budget}"] = _moves(mod.plan_rebalance(
            mod.clone_view(view), max_moves=budget))
    out["view after planning"] = _view_doc(view)  # clone_view protects it
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_planner_equals_the_reference(seed):
    doc, stale = topology_doc(seed)
    assert _plans(port, doc, stale) == _plans(ref, doc, stale)


class Recorder:
    """A PlanExecutor transport: records every call; a rebuild answers
    the shards the host lacked, and ``fail`` makes one path raise."""

    def __init__(self, view, fail: str = ""):
        self.view = view
        self.fail = fail
        self.calls: list = []

    def __call__(self, server: str, path: str, payload: dict,
                 timeout: float) -> dict:
        self.calls.append((server, path, dict(payload), timeout))
        if path == self.fail:
            raise RuntimeError(f"{path} failed on {server}")
        if path == "/admin/ec/rebuild":
            vid = payload["volume_id"]
            have = {sid for sid, us in self.view.shards.get(vid, {}).items()
                    if server in us}
            copied = {c[2]["shard_ids"][0] for c in self.calls
                      if c[1] == "/admin/ec/copy" and c[0] == server}
            return {"rebuilt_shard_ids": sorted(
                set(range(14)) - have - copied)}
        return {}


def _execute(mod, doc: dict, stale: tuple, fail: str) -> list:
    out = []
    view = mod.view_from_status(doc, stale=stale)
    rec = Recorder(view, fail)
    ex = mod.PlanExecutor(post_fn=rec)
    for vid in sorted(view.shards):
        try:
            res = ex.execute_repair(view, vid, engine="tpu")
            res.pop("seconds", None)  # the port also times its legs
            out.append(("repair", vid, res))
        except Exception as e:  # noqa: BLE001 - compared below
            out.append(("repair", vid, type(e).__name__, str(e)))
    plan = mod.plan_rebalance(mod.clone_view(view))
    for mv in plan:
        try:
            ex.execute_move(view, mv)
            out.append(("move", _moves([mv])))
        except Exception as e:  # noqa: BLE001 - compared below
            out.append(("move", _moves([mv]), type(e).__name__, str(e)))
    out.append(("calls", rec.calls))
    out.append(("view", _view_doc(view)))
    return out


@pytest.mark.parametrize("fail", ["", "/admin/ec/mount", "/admin/ec/copy"])
@pytest.mark.parametrize("seed", SEEDS[:6])
def test_executor_equals_the_reference(seed, fail):
    doc, stale = topology_doc(seed)
    got = _execute(port, doc, stale, fail)
    want = _execute(ref, doc, stale, fail)
    assert got == want
    assert any(c[1] == "/admin/ec/rebuild" for c in got[-2][1]) or \
        not any(e[0] == "repair" and isinstance(e[2], dict) and e[2]["host"]
                for e in got[:-2])


def test_repair_sends_the_servers_own_engine_by_default():
    """The reference's executor asks for "cpu", which a card server of
    the port refuses; the port's asks for "tpu" unless told otherwise."""
    doc = {"DataCenters": [{"Id": "dc", "Racks": [{"Id": "r", "DataNodes": [
        {"Url": f"h{i}:80", "Free": 5, "EcShards": 0} for i in range(3)]}]}],
        "EcVolumes": {"1": {str(s): [f"h{s % 3}:80"] for s in range(12)}},
        "EcCollections": {"1": "c"}}
    engines = {}
    for name, mod in (("port", port), ("ref", ref)):
        view = mod.view_from_status(doc)
        rec = Recorder(view)
        mod.PlanExecutor(post_fn=rec).execute_repair(view, 1)
        engines[name] = [c[2]["engine"] for c in rec.calls
                         if c[1] == "/admin/ec/rebuild"]
    assert engines == {"port": ["tpu"], "ref": ["cpu"]}
