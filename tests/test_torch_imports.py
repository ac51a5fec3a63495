"""The import boundary of the PyTorch port: it imports neither JAX nor any
module of the JAX package (``lizardfs_tpu``), and nor does chip_smoke.py.
The port's master imports no torch either, so that a standalone master
forks its metadata dumps as the JAX package's does, and nor do the
election, the metalogger and the operator tools that run beside it; the
file CLI (``tools/cli.py``) alone reaches the card.

The check runs in a subprocess, because this test process has JAX
loaded already (tests/conftest.py), plus an AST scan of the sources.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "lizardfs_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (
        name == "jax" or name.startswith("jax.")
        or name == "lizardfs_tpu" or name.startswith("lizardfs_tpu.")
    )


def _modules() -> list[str]:
    mods = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods + ["chip_smoke"]


def test_forbidden_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("lizardfs_tpu") and _forbidden("lizardfs_tpu.ops.gf256")
    assert not _forbidden("lizardfs_tpu_torch") and not _forbidden("lizardfs_tpu_torch.ops")
    assert not _forbidden("jaxlib_like")


def test_importing_the_port_loads_no_jax_and_no_reference_module():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=240,
    )
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "lizardfs_tpu_torch.core.encoder" in loaded and "chip_smoke" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_reference_module(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


@pytest.mark.parametrize("module", [
    "lizardfs_tpu_torch.master.server", "lizardfs_tpu_torch.master.__main__",
    "lizardfs_tpu_torch.ha.election", "lizardfs_tpu_torch.ha.controller",
    "lizardfs_tpu_torch.metalogger.server", "lizardfs_tpu_torch.metalogger.__main__",
    "lizardfs_tpu_torch.runtime.detsched", "lizardfs_tpu_torch.tools.metadump",
    "lizardfs_tpu_torch.tools.metarestore", "lizardfs_tpu_torch.tools.admin_cli",
    "lizardfs_tpu_torch.tools.webui",
])
def test_the_master_loads_no_torch(module):
    """The master, and what runs beside it (the election, the metalogger,
    the deterministic loop and the operator tools but the file CLI)."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "from lizardfs_tpu_torch.master import server\n"
        "print(json.dumps([sorted(sys.modules), server._fork_safe()]))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr
    loaded, fork_safe = json.loads(res.stdout.strip().splitlines()[-1])
    assert module in loaded and "lizardfs_tpu_torch.master.metadata" in loaded
    assert [m for m in loaded if m == "torch" or m.startswith("torch.")] == []
    assert [m for m in loaded if _forbidden(m)] == []
    assert fork_safe, "a master process without torch forks its dumps"


def test_the_client_loads_no_jax_and_no_reference_module():
    code = (
        "import json, sys\n"
        "import lizardfs_tpu_torch.client.client\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "lizardfs_tpu_torch.client.cache" in loaded and "lizardfs_tpu_torch.core.encoder" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
