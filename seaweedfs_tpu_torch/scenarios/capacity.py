"""SLO capacity probe: the max sustainable rps per route class.

The port's copy of seaweedfs_tpu/scenarios/capacity.py: the highest rate
each route class of a live cluster sustains under a declared SLO, what
an operator knows of the headroom before a crowd arrives.

  measure_rate()   — ONE open-loop measurement: ops are scheduled on a
      fixed global clock (slot k fires at t0 + k/rps, workers pull
      slots from a shared counter) so a saturated server cannot slow
      its own load down — it shows up as schedule lag and a collapsing
      achieved rate, exactly like real arrivals.  Emits achieved rps,
      p50/p99 service latency, error ratio, and max schedule lag.

  find_capacity()  — ramp (double the target until the SLO breaks or
      the schedule cannot be kept) then binary-search the bracket: the
      highest rate the SLO survives is ``capacity_rps``; the first
      breaching step is the ``knee`` (rate + which bound broke).
      Given ``clients`` (``_Clients``), every step runs on the same
      long-lived threads, whose pooled connections stay open from step
      to step; ``probe_cluster`` gives each route's search its own.  The
      reference starts new threads (and so new connections) each step,
      and times each one's first op.

  probe_cluster()  — drive real route classes (http_read, native_read,
      http_write) against a live cluster, attach the bounding-resource
      attribution (a forced-sample stitched trace fetched from the
      master mid-load names the bounding hop; the server's
      network-vs-server split classifies the resource), and return the
      document the shell's ``capacity.probe`` posts to the master.

A measurement is "sustainable" only when BOTH hold: the SLO (p99 and
error ratio) passes AND the achieved rate kept up with the schedule
(>= 92% of target) — a probe that quietly under-delivered its load and
then passed the SLO proves nothing.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import asdict, dataclass
from typing import Callable, Optional

from .workload import percentile as _percentile


@dataclass
class CapacitySLO:
    """The declared bar a capacity number is conditional on.  The
    defaults are the dataplane refactor's acceptance SLO: p99 < 5ms,
    error ratio < 0.1%."""
    max_p99_ms: float = 5.0
    max_error_ratio: float = 0.001

    def to_dict(self) -> dict:
        return asdict(self)


class _Clients:
    """A probe's client threads, alive from one step to the next.

    The pooled HTTP client and the framed client keep their connections
    per thread, so a step that starts threads of its own times each new
    thread's connects with its first requests.  A low-rate step of the
    search holds a few requests, every one a new thread's first, and its
    nearest-rank p99 is its slowest: it would time a connect, not the
    service.  These threads keep their connections open across the
    steps, as a real client's pool does, and each one's first call of
    the op, made before any step's clock starts, is unmeasured."""

    def __init__(self):
        self._inboxes: list[queue.SimpleQueue] = []
        self._threads: list[threading.Thread] = []
        self._done: queue.SimpleQueue = queue.SimpleQueue()

    def _serve(self, inbox: queue.SimpleQueue, warm: Callable) -> None:
        try:
            warm()
        except Exception:  # noqa: BLE001 - the warm-up is unmeasured
            pass
        self._done.put(None)
        while True:
            task = inbox.get()
            if task is None:
                return
            try:
                task()
            finally:
                self._done.put(None)

    def grow(self, n: int, warm: Callable[[], bool]) -> None:
        """At least ``n`` threads, each new one warmed by one ``warm()``."""
        new = max(n - len(self._threads), 0)
        for _ in range(new):
            inbox: queue.SimpleQueue = queue.SimpleQueue()
            t = threading.Thread(target=self._serve, args=(inbox, warm),
                                 daemon=True,
                                 name=f"cap-client-{len(self._threads)}")
            self._inboxes.append(inbox)
            self._threads.append(t)
            t.start()
        for _ in range(new):
            self._done.get()

    def run(self, n: int, fn: Callable[[], None]) -> None:
        """``fn`` on ``n`` of the threads at once; returns when all end."""
        for inbox in self._inboxes[:n]:
            inbox.put(fn)
        for _ in range(n):
            self._done.get()

    def close(self) -> None:
        for inbox in self._inboxes:
            inbox.put(None)
        for t in self._threads:
            t.join()
        self._inboxes, self._threads = [], []

    def __enter__(self) -> "_Clients":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def measure_rate(op: Callable[[], bool], rps: float, duration_s: float,
                 workers: int = 0, clients: Optional[_Clients] = None) -> dict:
    """One open-loop step at target ``rps`` for ``duration_s``.  ``op``
    performs one operation and returns ok (False = error; an exception
    counts as an error too).  Worker threads pull slot indices from a
    shared cursor and sleep until their slot's scheduled time — lag
    accumulates when the pool cannot keep up, and the achieved rate is
    computed against the wall, not the schedule.  The workers are
    ``clients``' threads (``_Clients``), or the step's own when None;
    each new one's first op is a warm-up, before the step's clock."""
    rps = max(float(rps), 0.1)
    interval = 1.0 / rps
    n_slots = max(int(duration_s * rps), 1)
    if workers <= 0:
        # enough concurrency to cover ~40ms of service time at the
        # target rate before the schedule slips, bounded for sanity
        workers = max(4, min(64, int(rps * 0.04) + 1))
    own = clients is None
    if own:
        clients = _Clients()
    clients.grow(workers, op)
    cursor = [0]
    lock = threading.Lock()
    lat_ms: list[float] = []
    errors = [0]
    max_lag = [0.0]
    t0 = time.monotonic()

    def loop():
        while True:
            with lock:
                i = cursor[0]
                if i >= n_slots:
                    return
                cursor[0] += 1
            t_slot = t0 + i * interval
            delay = t_slot - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            lag = time.monotonic() - t_slot
            t_op = time.monotonic()
            try:
                ok = op()
            except Exception:
                ok = False
            dt_ms = (time.monotonic() - t_op) * 1e3
            with lock:
                if ok:
                    lat_ms.append(dt_ms)
                else:
                    errors[0] += 1
                if lag > max_lag[0]:
                    max_lag[0] = lag

    try:
        clients.run(workers, loop)
    finally:
        if own:
            clients.close()
    wall = max(time.monotonic() - t0, 1e-9)
    done = len(lat_ms) + errors[0]
    lat_ms.sort()
    return {
        "target_rps": round(rps, 1),
        "achieved_rps": round(done / wall, 1),
        "ops": done,
        "errors": errors[0],
        "error_ratio": round(errors[0] / done, 5) if done else 1.0,
        "p50_ms": round(_percentile(lat_ms, 0.50), 3),
        "p99_ms": round(_percentile(lat_ms, 0.99), 3),
        "max_lag_ms": round(max_lag[0] * 1e3, 1),
        "workers": workers,
    }


def _sustainable(step: dict, slo: CapacitySLO) -> tuple[bool, str]:
    """-> (ok, breach reason).  The reason string is the knee's
    bound-that-broke attribution."""
    if step["achieved_rps"] < 0.92 * step["target_rps"]:
        return False, "throughput (schedule could not be kept)"
    if step["error_ratio"] > slo.max_error_ratio:
        return False, (f"error_ratio {step['error_ratio']:.3%} > "
                       f"{slo.max_error_ratio:.3%}")
    if step["p99_ms"] > slo.max_p99_ms:
        return False, (f"p99 {step['p99_ms']:.1f}ms > "
                       f"{slo.max_p99_ms:g}ms")
    return True, ""


def find_capacity(op: Callable[[], bool],
                  slo: Optional[CapacitySLO] = None,
                  start_rps: float = 50.0, max_rps: float = 100000.0,
                  step_s: float = 2.0, search_steps: int = 4,
                  clients: Optional[_Clients] = None) -> dict:
    """Ramp + binary search for the max sustainable rps under the SLO.
    Returns capacity_rps (the highest rate that passed; its achieved
    rps, which is what the server really did), the knee (first
    breaching step + which bound broke), and the full ramp so a reader
    can see the curve, not just the answer.  ``clients``: every step
    runs on these long-lived threads (``measure_rate``)."""
    slo = slo or CapacitySLO()
    on = {"clients": clients} if clients is not None else {}
    samples: list[dict] = []
    best: Optional[dict] = None
    knee: Optional[dict] = None
    rps = max(float(start_rps), 1.0)
    # ramp: double until the SLO breaks or the cap is reached
    while rps <= max_rps:
        step = measure_rate(op, rps, step_s, **on)
        ok, reason = _sustainable(step, slo)
        step["sustainable"] = ok
        samples.append(step)
        if not ok:
            knee = dict(step, reason=reason)
            break
        best = step
        rps *= 2.0
    if best is None and knee is not None:
        # start_rps itself breached: the capacity lives BELOW the
        # starting guess, not at zero — halve down until a step
        # sustains (or the floor proves the service really cannot
        # serve the SLO at any rate)
        rps = knee["target_rps"] / 2.0
        while rps >= 1.0:
            step = measure_rate(op, rps, step_s, **on)
            ok, reason = _sustainable(step, slo)
            step["sustainable"] = ok
            samples.append(step)
            if ok:
                best = step
                break
            knee = dict(step, reason=reason)
            rps /= 2.0
    if best is not None and knee is not None:
        # binary search the bracket (last good, first bad)
        lo, hi = best["target_rps"], knee["target_rps"]
        for _ in range(max(int(search_steps), 0)):
            mid = (lo + hi) / 2.0
            if hi - lo < max(0.05 * lo, 1.0):
                break
            step = measure_rate(op, mid, step_s, **on)
            ok, reason = _sustainable(step, slo)
            step["sustainable"] = ok
            samples.append(step)
            if ok:
                best, lo = step, mid
            else:
                knee, hi = dict(step, reason=reason), mid
    return {
        "slo": slo.to_dict(),
        "capacity_rps": best["achieved_rps"] if best else 0.0,
        "capacity_target_rps": best["target_rps"] if best else 0.0,
        "capacity_p99_ms": best["p99_ms"] if best else 0.0,
        "knee_rps": knee["target_rps"] if knee else None,
        "knee": ({"p99_ms": knee["p99_ms"],
                  "error_ratio": knee["error_ratio"],
                  "achieved_rps": knee["achieved_rps"],
                  "reason": knee["reason"]} if knee else None),
        "samples": samples,
    }


# --- live route classes ------------------------------------------------------

def _preload_fids(master_url: str, count: int = 64,
                  size: int = 4096) -> list[tuple[str, str]]:
    """Write `count` small objects; -> [(fid, volume url)]."""
    from ..utils.httpd import http_bytes, http_json

    out = []
    payload = b"\xa5" * size
    for i in range(count):
        r = http_json("GET", f"http://{master_url}/dir/assign?count=1",
                      timeout=15.0)
        st, body, _ = http_bytes("POST", f"http://{r['url']}/{r['fid']}",
                                 payload, timeout=30.0)
        if st not in (200, 201):
            raise RuntimeError(f"capacity preload {r['fid']} -> {st}: "
                               f"{body[:120]!r}")
        out.append((r["fid"], r["url"]))
    return out


def _attribute_bound(master_url: str, probe_url: str,
                     fid: str) -> dict:
    """Bounding-resource attribution: force-sample ONE read mid-load,
    fetch its stitched trace from the master, and name the bounding
    hop + the network-vs-server second split.  Best-effort — tracing
    may be off, and a capacity number without attribution is still a
    capacity number."""
    from ..observability import context as _trace_context
    from ..utils.httpd import http_bytes, http_json

    try:
        # the forced request must open its OWN trace, not ride an
        # ambient one (shell commands force-sample themselves: without
        # this scope, `capacity.probe` would fetch the whole command's
        # trace — preloads included — and misattribute the bound)
        prev = _trace_context.activate(None)
        try:
            _st, _b, hdrs = http_bytes(
                "GET", f"http://{probe_url}/{fid}",
                headers={"X-Force-Trace": "1"}, timeout=10.0)
        finally:
            _trace_context.activate(prev)
        trace_id = hdrs.get("X-Trace-Id", "")
        if not trace_id:
            return {"resource": "unknown",
                    "detail": "tracing off (no X-Trace-Id)"}
        deadline = time.time() + 6.0
        doc = None
        while time.time() < deadline:
            try:
                doc = http_json(
                    "GET",
                    f"http://{master_url}/cluster/traces/{trace_id}",
                    timeout=5.0)
                break
            except Exception:
                time.sleep(0.2)
        if not doc:
            return {"resource": "unknown",
                    "detail": "stitched trace never reached collector"}
        an = doc.get("analysis") or {}
        # server_s is the analyzer's PER-SERVER self-time map; the
        # resource classification wants the totals
        server_s = sum(float(v) for v in
                       (an.get("server_s") or {}).values())
        network_s = float(an.get("network_s") or 0.0)
        resource = "server" if server_s >= network_s else "network"
        bounding = an.get("bounding_hop") or {}
        if bounding.get("kind") == "hop":
            hop = (f"{bounding.get('from')} -> {bounding.get('to')} "
                   f"{bounding.get('op')}")
        elif bounding.get("kind") == "local":
            hop = f"{bounding.get('op')} on {bounding.get('server')}"
        else:
            hop = ""
        out = {"resource": resource, "bounding_hop": hop,
               "server_s": round(server_s, 4),
               "network_s": round(network_s, 4),
               "trace_id": trace_id}
        # resource-ledger citation (best-effort): the merged ledger's
        # row for the probed route class says what the route costs
        # cluster-wide RIGHT NOW — CPU share and queue-wait back the
        # single-trace attribution with the population it came from
        try:
            led = http_json(
                "GET", f"http://{master_url}/cluster/ledger?top=64",
                timeout=5.0)
            for row in led.get("routes") or []:
                if row.get("route") == "http_read":
                    out["ledger"] = {
                        "route": "http_read",
                        "cpu_rate_s_per_s": row.get("cpu_rate", 0.0),
                        "cpu_share": row.get("cpu_share", 0.0),
                        "queue_wait_s_per_s":
                            row.get("queue_wait_rate", 0.0),
                        "req_rate": row.get("req_rate", 0.0),
                    }
                    break
        except Exception:
            pass
        return out
    except Exception as e:
        return {"resource": "unknown",
                "detail": f"{type(e).__name__}: {e}"[:200]}


def probe_cluster(master_url: str,
                  routes: tuple = ("http_read", "native_read",
                                   "http_write"),
                  slo: Optional[CapacitySLO] = None,
                  start_rps: float = 100.0, max_rps: float = 50000.0,
                  step_s: float = 2.0, preload: int = 64,
                  write_size: int = 1024) -> dict:
    """Probe a LIVE cluster's per-route-class capacity.  http_read and
    native_read hammer preloaded objects through the pooled HTTP /
    framed-TCP clients; http_write assigns + uploads fresh objects.
    Each class gets its own ramp + search and its own bounding-resource
    attribution.  The returned document is what the master parks at
    POST /cluster/capacity."""
    import random as _random

    from ..utils.framing import tcp_address
    from ..utils.httpd import http_bytes, http_json
    from ..volume_server.tcp import TcpVolumeClient

    slo = slo or CapacitySLO()
    fids = _preload_fids(master_url, count=preload, size=write_size)
    rng = _random.Random(0xCAFE)
    tcp_client = TcpVolumeClient()
    doc: dict = {"slo": slo.to_dict(), "routes": {},
                 "probed_at": round(time.time(), 3),
                 "master": master_url}

    def http_read_op() -> bool:
        fid, url = fids[rng.randrange(len(fids))]
        st, _b, _h = http_bytes("GET", f"http://{url}/{fid}",
                                timeout=10.0)
        return 200 <= st < 300

    def native_read_op() -> bool:
        fid, url = fids[rng.randrange(len(fids))]
        try:
            tcp_client.read(tcp_address(url), fid)
            return True
        except Exception:
            return False

    payload = b"\x5a" * write_size

    def http_write_op() -> bool:
        try:
            r = http_json("GET",
                          f"http://{master_url}/dir/assign?count=1",
                          timeout=10.0)
            st, _b, _h = http_bytes(
                "POST", f"http://{r['url']}/{r['fid']}", payload,
                timeout=10.0)
            return 200 <= st < 300
        except Exception:
            return False

    ops = {"http_read": http_read_op, "native_read": native_read_op,
           "http_write": http_write_op}
    for route in routes:
        op = ops.get(route)
        if op is None:
            doc["routes"][route] = {"error": f"unknown route {route!r}"}
            continue
        with _Clients() as clients:
            res = find_capacity(op, slo, start_rps=start_rps,
                                max_rps=max_rps, step_s=step_s,
                                clients=clients)
        # attribution mid-shape: one forced trace right after the
        # search, while the connection pools and caches are still hot
        fid, url = fids[0]
        res["bounding"] = _attribute_bound(master_url, url, fid)
        doc["routes"][route] = res
    return doc


def render_capacity(doc: dict) -> str:
    """One stable line per route class — the shell view."""
    lines = []
    slo = doc.get("slo") or {}
    lines.append(f"capacity probe (SLO: p99 < {slo.get('max_p99_ms')}ms, "
                 f"errors < {slo.get('max_error_ratio', 0):.2%})")
    for route, res in sorted((doc.get("routes") or {}).items()):
        if "error" in res:
            lines.append(f"  {route:<12} error: {res['error']}")
            continue
        knee = res.get("knee")
        knee_s = (f" knee@{res.get('knee_rps'):g}rps "
                  f"({knee['reason']})" if knee else " (no knee found)")
        bound = (res.get("bounding") or {}).get("resource", "unknown")
        hop = (res.get("bounding") or {}).get("bounding_hop", "")
        lines.append(
            f"  {route:<12} capacity={res.get('capacity_rps', 0):g} rps"
            f" p99={res.get('capacity_p99_ms', 0):g}ms"
            f"{knee_s} bound={bound}"
            + (f" [{hop}]" if hop else ""))
        led = (res.get("bounding") or {}).get("ledger")
        if led:
            lines.append(
                f"  {'':<12} ledger: {led['route']} at "
                f"{led.get('cpu_rate_s_per_s', 0) * 1000:.1f} cpu-ms/s "
                f"({led.get('cpu_share', 0):.0%} of cluster), "
                f"queue-wait "
                f"{led.get('queue_wait_s_per_s', 0) * 1000:.1f} ms/s "
                f"over {led.get('req_rate', 0):g} req/s")
    return "\n".join(lines)
