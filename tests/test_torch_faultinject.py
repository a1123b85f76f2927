"""The port's fault-point registry against its instrumented sites.

Every name a ``faultinject.hit()`` / ``faultinject.corrupt_block()`` call
(or a ``drain_point=`` the streaming encoder hands to its drain) names in
``seaweedfs_tpu_torch/`` is in ``FAULT_POINTS``, and every registered
point is named at such a site.  The reference's points the port has no
code for (``ec.worker.ack``, ``ec.shm``, ``loop.block`` and the ``net.*``
points) are not listed.
"""

from __future__ import annotations

import ast
import pathlib
import time

import pytest

from seaweedfs_tpu.utils import faultinject as ref_fi
from seaweedfs_tpu_torch.utils import faultinject as fi

PORT = pathlib.Path(__file__).resolve().parent.parent / "seaweedfs_tpu_torch"


def site_names() -> dict[str, list[str]]:
    """Point name -> the port files whose code names it."""
    sites: dict[str, list[str]] = {}
    for path in sorted(PORT.rglob("*.py")):
        if path.name == "faultinject.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else \
                getattr(func, "id", "")
            args = []
            if name in ("hit", "corrupt_block") and node.args:
                args.append(node.args[0])
            args += [kw.value for kw in node.keywords
                     if kw.arg == "drain_point"]
            for a in args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    sites.setdefault(a.value, []).append(
                        str(path.relative_to(PORT)))
    return sites


def test_every_site_is_registered_and_every_point_is_hit():
    sites = site_names()
    assert set(sites) == set(fi.FAULT_POINTS), sites
    # each description names a module of the port that hits it
    for name, files in sites.items():
        assert any(f in fi.FAULT_POINTS[name] for f in files), (name, files)


def test_the_port_lists_a_subset_of_the_reference_s_points():
    assert set(fi.FAULT_POINTS) <= set(ref_fi.FAULT_POINTS)
    left_out = set(ref_fi.FAULT_POINTS) - set(fi.FAULT_POINTS)
    assert {"ec.worker.ack", "ec.shm", "loop.block"} <= left_out
    assert {"tier.upload", "tier.recall", "disk.read", "disk.write"} \
        <= set(fi.FAULT_POINTS)
    assert fi.list_points() == sorted(fi.FAULT_POINTS.items())


def test_weed_faults_delay_stalls_each_hit_like_the_reference():
    """``WEED_FAULTS="coord.exec:delay=..."`` (the failover drill's slowed
    repair legs in a master process): each hit sleeps, counts as
    injected, and max_hits ends it, in both packages."""
    for mod in (fi, ref_fi):
        mod.clear()
        try:
            assert mod.arm_from_env("coord.exec:delay=0.2,max_hits=2") == 1
            waits = []
            for _ in range(3):
                t0 = time.monotonic()
                mod.hit("coord.exec")
                waits.append(time.monotonic() - t0)
            assert waits[0] >= 0.2 and waits[1] >= 0.2, (mod, waits)
            assert waits[2] < 0.1, (mod, waits)
            assert mod.fired("coord.exec") == 2
        finally:
            mod.clear()


def test_delay_then_error_and_the_after_window():
    fi.clear()
    try:
        fi.enable("coord.exec", error_rate=1.0, delay=0.1, max_hits=1,
                  after=1)
        t0 = time.monotonic()
        fi.hit("coord.exec")  # inside the after window: free
        assert time.monotonic() - t0 < 0.1
        t0 = time.monotonic()
        with pytest.raises(OSError):
            fi.hit("coord.exec")
        assert time.monotonic() - t0 >= 0.1
        fi.hit("coord.exec")  # spent
        assert fi.fired("coord.exec") == 1
    finally:
        fi.clear()
