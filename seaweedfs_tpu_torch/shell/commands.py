"""Admin shell: command registry, CommandEnv, REPL, basic commands.

The port's copy of seaweedfs_tpu/shell/commands.py (weed/shell/
commands.go + shell_liner.go).  Commands register into COMMANDS via
@command; mutating commands must hold the master's admin lock
(command_lock_unlock.go semantics via env.confirm_is_locked).

Every command is a force-sampled trace root: its Traceparent reaches
every server it calls, ``env.last_trace_id`` names it, and a bare
``trace.fetch`` shows the previous command's stitched trace.  With the
tracer on (``-trace.sample``) the command records a ``shell.<name>``
span.
"""

from __future__ import annotations

import json
import shlex
from typing import Callable, Optional

from ..client.operation import MasterClient
from ..observability import context as _trace_context
from ..observability import get_tracer
from ..utils.httpd import HttpError, http_json

COMMANDS: dict[str, Callable] = {}
HELP: dict[str, str] = {}


def command(name: str):
    def deco(fn):
        COMMANDS[name] = fn
        HELP[name] = (fn.__doc__ or "").strip()
        return fn

    return deco


class CommandEnv:
    def __init__(self, master_url: str):
        self.master_url = master_url
        self.master = MasterClient(master_url)
        self.admin_token: Optional[int] = None
        # the trace ids of the last command and the one before it
        self.last_trace_id = ""
        self.prev_trace_id = ""

    # --- master helpers ---------------------------------------------------
    def master_get(self, path: str,
                   timeout: Optional[float] = 30.0) -> dict:
        return http_json("GET", f"http://{self.master_url}{path}",
                         timeout=timeout)

    def master_post(self, path: str, payload: dict) -> dict:
        return http_json("POST", f"http://{self.master_url}{path}", payload,
                         timeout=30.0)

    def volume_post(self, server: str, path: str, payload: dict,
                    timeout: float = 600.0) -> dict:
        return http_json("POST", f"http://{server}{path}", payload,
                         timeout=timeout)

    def topology(self) -> dict:
        return self.master_get("/dir/status")["Topology"]

    # --- admin lock (commands.go:73 confirmIsLocked) ----------------------
    def lock(self) -> None:
        r = self.master_post("/admin/lease", {
            "client_name": "shell", "previous_token": self.admin_token})
        self.admin_token = r["token"]

    def unlock(self) -> None:
        if self.admin_token is not None:
            self.master_post("/admin/release",
                             {"previous_token": self.admin_token})
            self.admin_token = None

    def confirm_is_locked(self) -> None:
        if self.admin_token is None:
            raise RuntimeError(
                "lock is needed: run `lock` before mutating commands")


# flags that never take a value (so `fs.rm -r /path` keeps /path
# positional); the reference's set, so a line parses the same in both
BOOL_FLAGS = {"r", "rf", "l", "f", "force", "writable", "readonly", "apply",
              "recursive", "v", "json", "backfill", "all", "chrome",
              "firing", "include_ops", "recall"}


def parse_flags(args: list[str]) -> dict[str, str]:
    """-volumeId 1 -collection x plus boolean flags; the first bare token
    lands under the '' key (a positional argument)."""
    out: dict[str, str] = {}
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-"):
            name = a.lstrip("-")
            if (name not in BOOL_FLAGS and i + 1 < len(args)
                    and not args[i + 1].startswith("-")):
                out[name] = args[i + 1]
                i += 2
            else:
                out[name] = "true"
                i += 1
        else:
            out.setdefault("", a)
            i += 1
    return out


def run_command(env: CommandEnv, line: str) -> object:
    parts = shlex.split(line)
    if not parts:
        return None
    name, args = parts[0], parts[1:]
    if name in ("help", "?"):
        if args and args[0] in HELP:
            return HELP[args[0]]
        return "commands: " + ", ".join(sorted(COMMANDS))
    fn = COMMANDS.get(name)
    if fn is None:
        raise KeyError(f"unknown command {name!r}; try `help`")
    # force-sampled: operator commands are rare, and the decision
    # travels in the Traceparent to every server the command reaches
    ctx = _trace_context.TraceContext(_trace_context.new_trace_id())
    prev = _trace_context.activate(ctx)
    env.prev_trace_id = env.last_trace_id
    env.last_trace_id = ctx.trace_id
    try:
        tracer = get_tracer()
        if tracer.enabled:
            with tracer.span(f"shell.{name}"):
                return fn(env, parse_flags(args))
        return fn(env, parse_flags(args))
    finally:
        _trace_context.activate(prev)


def repl(master_url: str) -> None:
    env = CommandEnv(master_url)
    print(f"connected to master {master_url}; `help` lists commands")
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            break
        if line.strip() in ("exit", "quit"):
            break
        try:
            out = run_command(env, line)
            if out is not None:
                print(out)
            # the command's trace id, for `trace.fetch`; only with the
            # tracer on (with it off nothing is collected)
            if (env.last_trace_id and get_tracer().enabled
                    and not line.strip().startswith("trace.")):
                print(f"[trace {env.last_trace_id} — `trace.fetch` "
                      "shows the cluster view]")
        except (HttpError, RuntimeError, KeyError, ValueError) as e:
            print(f"error: {e}")
    env.unlock()


# --- basic commands ---------------------------------------------------------

@command("lock")
def cmd_lock(env: CommandEnv, flags: dict) -> str:
    """lock  # acquire the exclusive admin lock"""
    env.lock()
    return "locked"


@command("unlock")
def cmd_unlock(env: CommandEnv, flags: dict) -> str:
    """unlock  # release the admin lock"""
    env.unlock()
    return "unlocked"


@command("cluster.ps")
def cmd_cluster_ps(env: CommandEnv, flags: dict) -> str:
    """cluster.ps  # show cluster processes"""
    status = env.master_get("/cluster/status")
    topo = env.topology()
    lines = [f"master: {status['Leader']} (leader)"]
    for dc in topo["DataCenters"]:
        for rack in dc["Racks"]:
            for n in rack["DataNodes"]:
                lines.append(
                    f"volume server: {n['Url']} dc={dc['Id']} rack={rack['Id']} "
                    f"volumes={n['Volumes']} ec_shards={n['EcShards']} "
                    f"free={n['Free']}")
    return "\n".join(lines)


@command("volume.list")
def cmd_volume_list(env: CommandEnv, flags: dict) -> str:
    """volume.list  # list topology: volumes + ec shards per node"""
    topo = env.topology()
    lines = []
    for dc in topo["DataCenters"]:
        lines.append(f"DataCenter {dc['Id']}")
        for rack in dc["Racks"]:
            lines.append(f"  Rack {rack['Id']}")
            for n in rack["DataNodes"]:
                lines.append(f"    DataNode {n['Url']} "
                             f"volumes={n['VolumeIds']} free={n['Free']}")
    for vid, shards in sorted(topo.get("EcVolumes", {}).items()):
        locs = ", ".join(f"{sid}@{','.join(urls)}" for sid, urls in sorted(
            shards.items(), key=lambda kv: int(kv[0])))
        lines.append(f"  ec volume {vid}: {locs}")
    return "\n".join(lines)


@command("volume.vacuum")
def cmd_volume_vacuum(env: CommandEnv, flags: dict) -> str:
    """volume.vacuum [-garbageThreshold 0.3]  # compact volumes with garbage"""
    t = flags.get("garbageThreshold", "0.3")
    # the master bounds each replica's compact and commit itself; a
    # full-size volume takes minutes, so the shell waits for its answer
    # (the reference's shell gives up after 30 s)
    r = env.master_get(f"/vol/vacuum?garbageThreshold={t}", timeout=None)
    return f"compacted volumes: {r['compacted']}"


@command("collection.list")
def cmd_collection_list(env: CommandEnv, flags: dict) -> str:
    """collection.list  # list collections"""
    topo = env.topology()
    names = sorted({layout["collection"] for layout in topo.get("Layouts", [])})
    return "\n".join(n or "(default)" for n in names) or "(none)"


@command("fault.list")
def cmd_fault_list(env: CommandEnv, flags: dict) -> str:
    """fault.list [-json]  # the fault-injection registry: every armable
    # fault point with a one-line description"""
    from ..utils import faultinject as fi

    if flags.get("json") == "true":
        return json.dumps(dict(fi.list_points()), indent=2)
    lines = [f"fault points: {len(fi.FAULT_POINTS)} registered "
             "(arm via seaweedfs_tpu_torch.utils.faultinject.enable)"]
    for name, desc in fi.list_points():
        lines.append(f"  {name:<18} {desc}")
    return "\n".join(lines)


@command("volume.grow")
def cmd_volume_grow(env: CommandEnv, flags: dict) -> str:
    """volume.grow [-collection x] [-replication 000] [-count 1]"""
    q = (f"collection={flags.get('collection', '')}"
         f"&replication={flags.get('replication', '')}"
         f"&count={flags.get('count', '1')}")
    r = env.master_get(f"/vol/grow?{q}")
    return f"grew volumes: {r['volumeIds']}"
