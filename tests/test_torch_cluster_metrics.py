"""The port's metrics and cluster aggregation against the reference's.

stats/metrics.py and stats/aggregate.py of both packages: the same
seeded collector operations expose the same text; the same seeded
expositions go through ``parse_prometheus_text`` -> ``merge_families``
-> ``expose`` to the same text; the reference's aggregator unit cases
(stale peer, never-scraped peer, unregistered peer, min-interval rate
limit) run on both ``ClusterAggregator``s; and ``health()`` documents are
equal for the same fake fetches, the scrape ages masked.  Live: the
port's volume server's ``GET /metrics`` parses with the reference's
parser and carries its volume and EC-shard gauges.
"""

from __future__ import annotations

import numpy as np
import pytest

import seaweedfs_tpu.stats.aggregate as ref_agg
import seaweedfs_tpu.stats.metrics as ref_metrics
import seaweedfs_tpu_torch.stats.aggregate as port_agg
import seaweedfs_tpu_torch.stats.metrics as port_metrics

PACKAGES = [(port_metrics, port_agg), (ref_metrics, ref_agg)]
IDS = ["port", "reference"]
SEEDS = list(range(8))
LABEL_VALUES = ["GET", "PUT", "", 'a"b\\c\nd', "héllo", "x y"]
BUCKETS = [(0.001, 0.01, 0.1, 1.0), (0.5, 2.0), ()]


def seeded_registry(metrics, seed: int, buckets=None):
    """A registry filled by seeded operations, through ``metrics``'s own
    collectors."""
    rng = np.random.default_rng(seed)
    reg = metrics.Registry()
    for f in range(int(rng.integers(1, 4))):
        c = reg.counter(f"t_c{f}_total", f"counter {f}", labels=("type",))
        for _ in range(int(rng.integers(0, 6))):
            c.inc(LABEL_VALUES[int(rng.integers(len(LABEL_VALUES)))],
                  amount=float(rng.integers(1, 5)))
    g = reg.gauge("t_gauge", "a gauge", labels=("collection", "type"))
    for _ in range(int(rng.integers(1, 5))):
        g.set(LABEL_VALUES[int(rng.integers(3))], "volume",
              float(rng.integers(0, 1000)) / 8)
    plain = reg.gauge("t_plain", "no labels")
    plain.set(float(rng.integers(0, 50)))
    grid = buckets if buckets is not None else \
        BUCKETS[int(rng.integers(2))]
    h = reg.histogram("t_seconds", "a histogram", labels=("op",),
                      buckets=grid)
    for _ in range(int(rng.integers(0, 30))):
        h.observe(["read", "write"][int(rng.integers(2))],
                  float(rng.lognormal(-3, 2)))
    return reg


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_exposition_equals_the_reference(seed):
    texts = [seeded_registry(m, seed).expose() for m, _a in PACKAGES]
    assert texts[0] == texts[1]


def _merged_text(agg, texts: list[str]) -> str:
    merged: dict = {}
    parsed = [agg.parse_prometheus_text(t) for t in texts]
    for fams in parsed:
        agg.merge_families(merged, fams)
    lines = []
    for name in sorted(merged):
        lines.extend(merged[name].expose())
    # merging never mutated a peer's parsed families
    for fams, again in zip(parsed,
                           [agg.parse_prometheus_text(t) for t in texts]):
        for name in fams:
            assert fams[name].expose() == again[name].expose()
    return "\n".join(lines)


@pytest.mark.parametrize("seed", SEEDS)
def test_parse_merge_expose_equals_the_reference(seed):
    texts = [seeded_registry(ref_metrics, seed * 10 + p).expose()
             for p in range(3)]
    # a peer on another bucket grid lands under <name>_mismatch
    texts.append(seeded_registry(ref_metrics, seed, buckets=(7.0,)).expose())
    texts.append("untyped_metric 4.5\nuntyped_metric{a=\"1\"} 2\n"
                 "# TYPE t_h histogram\n"
                 't_h_bucket{le="1",x="y"} 3 # {trace_id="ab"} 0.5 12.5\n'
                 't_h_bucket{le="+Inf",x="y"} 4\nt_h_sum{x="y"} 9\n'
                 't_h_count{x="y"} 4\nnot a sample line\n')
    assert _merged_text(port_agg, texts) == _merged_text(ref_agg, texts)


# --- the reference's aggregator unit cases, on both packages ----------------

@pytest.mark.parametrize("metrics,agg", PACKAGES, ids=IDS)
def test_stale_peer_keeps_last_values(metrics, agg):
    text = seeded_registry(metrics, 0).expose()
    texts = {"a:1": text, "b:2": text}

    def fetch(url):
        if url not in texts:
            raise ConnectionError("down")
        return texts[url]

    a = agg.ClusterAggregator(lambda: ["a:1", "b:2"], fetch=fetch,
                              min_interval=0.0)
    a.scrape(force=True)
    before = a.merged()
    del texts["b:2"]  # the peer dies
    a.scrape(force=True)
    out = a.expose()
    # marked stale, not dropped and not an error: the counters hold
    assert 'SeaweedFS_cluster_peer_up{peer="b:2"} 0' in out
    assert 'SeaweedFS_cluster_peer_stale{peer="b:2"} 1' in out
    assert 'SeaweedFS_cluster_peer_up{peer="a:1"} 1' in out
    assert {n: c.expose() for n, c in a.merged().items()} == \
        {n: c.expose() for n, c in before.items()}
    assert a.health()["stale_peers"] == ["b:2"]


@pytest.mark.parametrize("metrics,agg", PACKAGES, ids=IDS)
def test_never_scraped_dead_peer(metrics, agg):
    def fetch(url):
        raise ConnectionError("no")

    a = agg.ClusterAggregator(lambda: ["x:1"], fetch=fetch, min_interval=0.0)
    a.scrape(force=True)
    st = a.peer_status()["x:1"]
    assert st["up"] is False and st["stale"] is True
    assert st["has_data"] is False
    assert a.health()["peers"]["x:1"]["pipeline_health"] == {
        k: 0 for k in ref_agg.HEALTH_FAMILIES}


@pytest.mark.parametrize("metrics,agg", PACKAGES, ids=IDS)
def test_unregistered_peer_drops_out(metrics, agg):
    peers = ["a:1", "b:2"]
    a = agg.ClusterAggregator(lambda: list(peers),
                              fetch=lambda u: "m_total 1\n",
                              min_interval=0.0)
    a.scrape(force=True)
    assert len(a.peer_status()) == 2
    peers.remove("b:2")  # left the topology: gone, not stale
    a.scrape(force=True)
    assert list(a.peer_status()) == ["a:1"]


@pytest.mark.parametrize("metrics,agg", PACKAGES, ids=IDS)
def test_min_interval_rate_limits(metrics, agg):
    calls = []
    scrubs = []
    a = agg.ClusterAggregator(lambda: ["a:1"],
                              fetch=lambda u: calls.append(u) or "x 1\n",
                              scrub_fetch=lambda u: scrubs.append(u) or {},
                              min_interval=60.0)
    a.scrape()
    a.scrape()
    a.scrape()
    assert len(calls) == 1 and scrubs == []
    # a scrub-inclusive call is not swallowed by the plain scrape's TTL
    a.scrape(include_scrub=True)
    a.scrape(include_scrub=True)
    assert len(calls) == 2 and len(scrubs) == 1


def _health_doc(agg, metrics, seed: int) -> list:
    """health() after seeded scrapes of seeded peers, the ages masked."""
    rng = np.random.default_rng(seed)
    peers = [f"10.0.0.{i}:8080" for i in range(int(rng.integers(1, 6)))]
    texts = {}
    for i, url in enumerate(peers):
        reg = seeded_registry(metrics, seed * 7 + i)
        integrity = metrics.ECIntegrityMetrics(reg)
        for _ in range(int(rng.integers(0, 3))):
            integrity.corrupt_shards.inc(
                ["scrub", "read", "rebuild"][int(rng.integers(3))])
        if rng.random() < 0.5:
            integrity.repairs.inc("unrepairable")
        if rng.random() < 0.3:
            reg.counter("SeaweedFS_ec_worker_restarts_total", "",
                        labels=("kind",)).inc("parity")
        # a peer's copy of a master-local family must not count
        metrics.CoordinatorMetrics(reg).under_replicated.set(3)
        texts[url] = reg.expose()
    scrub = {url: None if rng.random() < 0.3 else {
        "running": bool(rng.random() < 0.5), "passes": int(rng.integers(9)),
        "verdicts": {str(v): {"status": ["clean", "unrepairable", "repaired",
                                         None][int(rng.integers(4))]}
                     for v in range(int(rng.integers(0, 4)))}}
        for url in peers}
    down: set = set()

    def fetch(url):
        if url in down:
            raise ConnectionError("connection refused")
        return texts[url]

    local = {"ec_under_replicated": int(rng.integers(0, 3)),
             "coordinator_repair_failures": int(rng.integers(0, 2)),
             "not_a_total": 5}
    a = agg.ClusterAggregator(lambda: list(peers), fetch=fetch,
                              scrub_fetch=lambda u: scrub[u],
                              min_interval=0.0, local_fn=lambda: local)
    docs = []
    for _ in range(3):
        a.scrape(force=True, include_scrub=True)
        doc = a.health()
        for p in doc["peers"].values():
            p["age_s"] = p["age_s"] is not None  # a timestamp: masked
        docs.append(doc)
        down.add(peers[int(rng.integers(len(peers)))])
    return docs


@pytest.mark.parametrize("seed", SEEDS)
def test_health_documents_equal_the_reference(seed):
    assert _health_doc(port_agg, port_metrics, seed) == \
        _health_doc(ref_agg, ref_metrics, seed)


def test_health_keys_and_master_local_keys_are_the_reference():
    assert port_agg.HEALTH_FAMILIES == ref_agg.HEALTH_FAMILIES
    assert port_agg.MASTER_LOCAL_HEALTH_KEYS == \
        ref_agg.MASTER_LOCAL_HEALTH_KEYS


def test_integrity_and_coordinator_families_equal_the_reference():
    out = []
    for metrics, _agg in PACKAGES:
        reg = metrics.Registry()
        integ = metrics.ECIntegrityMetrics(reg)
        coord = metrics.CoordinatorMetrics(reg)
        integ.scrub_blocks.inc("ok", amount=7)
        integ.corrupt_shards.inc("scrub")
        integ.repairs.inc("repaired", amount=2)
        coord.repairs.inc("done")
        coord.repair_failures.inc("OSError")
        coord.moves.inc("spread", amount=3)
        coord.under_replicated.set(2)
        coord.queue_depth.set(1)
        coord.cycles.inc("ok")
        out.append((integ.totals(), reg.expose()))
    assert out[0] == out[1]


def test_volume_server_metrics_route(tmp_path):
    """The port server's /metrics: the reference's parser reads it; the
    volume and EC-shard gauges follow the live store; every route's
    request series exists."""
    import chip_smoke
    from seaweedfs_tpu_torch.utils.httpd import http_bytes, http_json
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer
    from tests.conftest import free_port

    vs = VolumeServer([str(tmp_path)], "127.0.0.1:1", port=free_port(),
                      pulse_seconds=60, device="cpu").start()
    try:
        http_json("POST", f"http://{vs.url}/admin/assign_volume",
                  {"volume_id": 1, "collection": "pics"})
        n = chip_smoke.http_needle(1, 0, 5, 0x1234, 3000)
        assert http_bytes("PUT", f"http://{vs.url}{n['path']}{n['query']}",
                          n["body"], n["headers"])[0] == 201

        def scrape() -> dict:
            status, body, headers = http_bytes("GET",
                                               f"http://{vs.url}/metrics")
            assert status == 200
            assert headers["Content-Type"].startswith(
                "text/plain; version=0.0.4")
            text.append(body.decode())
            return ref_agg.parse_prometheus_text(text[-1])

        text: list[str] = []

        fams = scrape()
        vols = fams["SeaweedFS_volumeServer_volumes"]
        assert vols.snapshot() == {("pics", "volume"): 1.0}
        assert fams["SeaweedFS_volumeServer_total_disk_size"].value(
            "pics", "volume") == vs.store.volumes[1].data_size
        assert fams["SeaweedFS_volumeServer_max_volumes"].value() == 8
        for path in ("/admin/readonly", "/admin/ec/generate",
                     "/admin/ec/mount", "/admin/delete_volume"):
            http_json("POST", f"http://{vs.url}{path}",
                      {"volume_id": 1, "collection": "pics"})
        fams = scrape()
        assert fams["SeaweedFS_volumeServer_volumes"].snapshot() == {
            ("pics", "ec_shards"): 14.0}
        reqs = fams["SeaweedFS_volumeServer_request_total"]
        assert reqs.value("write_object") >= 1
        assert "ec_scrub_start" in {k[0] for k in reqs.snapshot()}
        assert "SeaweedFS_volumeServer_request_seconds" in fams
        # no rot seen yet: the integrity families are declared, empty
        for family in ("SeaweedFS_ec_corrupt_shards_total",
                       "SeaweedFS_ec_scrub_repairs_total"):
            assert f"# TYPE {family} counter" in text[-1]
    finally:
        vs.stop()
