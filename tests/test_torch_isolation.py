"""The port stands alone: no jax, nothing of seaweedfs_tpu, and no silent
CPU path when a card was asked for."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "seaweedfs_tpu_torch")


def _port_sources() -> list[str]:
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "chip_phase.py")]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "build"]
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith(".py")]
    return sorted(out)


def test_the_sources_cover_the_framed_plane():
    rel = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {"utils/framing.py", "volume_server/tcp.py"} <= rel


def test_the_sources_cover_the_volume_store():
    rel = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {"storage/needle_map_compact.py", "storage/volume_write.py",
            "storage/volume_backup.py", "query/json_query.py",
            "images/resizing.py", "tools/see_dat.py"} <= rel


def test_the_sources_cover_the_native_plane_and_5_byte_offsets():
    rel = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {"volume_server/dataplane.py", "tools/see_idx.py"} <= rel
    assert os.path.exists(os.path.join(PORT, "csrc", "dataplane.cpp"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "seaweedfs_tpu"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                _forbidden(str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def test_import_loads_no_jax():
    code = ("import sys\n"
            "import seaweedfs_tpu_torch.volume_server.server\n"
            "import seaweedfs_tpu_torch.volume_server.tcp\n"
            "import seaweedfs_tpu_torch.utils.framing\n"
            "import seaweedfs_tpu_torch.__main__\n"
            "import seaweedfs_tpu_torch.interop\n"
            "import seaweedfs_tpu_torch.tools.see_dat\n"
            "import seaweedfs_tpu_torch.tools.see_idx\n"
            "import seaweedfs_tpu_torch.volume_server.dataplane\n"
            "mods = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'seaweedfs_tpu')]\n"
            "assert not mods, mods\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_default_device_raises_without_a_card(tmp_path):
    import torch

    from seaweedfs_tpu_torch.__main__ import main as cli_main
    from seaweedfs_tpu_torch.ec.codec import ReedSolomon
    from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
    from seaweedfs_tpu_torch.ops.gf_matmul import TorchEngine
    from seaweedfs_tpu_torch.volume_server.server import VolumeServer
    from seaweedfs_tpu_torch.volume_server.store import Store

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for make in (lambda: Store([str(tmp_path)]), StreamingEncoder,
                 TorchEngine, lambda: ReedSolomon(10, 4),
                 lambda: VolumeServer([str(tmp_path)], "127.0.0.1:1"),
                 lambda: cli_main(["volume", "-dir", str(tmp_path),
                                   "-port", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert not os.listdir(tmp_path)
