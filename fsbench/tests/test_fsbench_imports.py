"""The import boundary: nothing the benchmark runs loads JAX or the JAX
package (``lizardfs_tpu``), compared by whole top-level names since the
port's name begins with the JAX package's; and the plain reference loads
nothing of the program either."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FSBENCH = os.path.join(ROOT, "fsbench")


def _loaded(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tops(mods):
    return {m.split(".")[0] for m in mods}


def test_top_level_names_compare_whole():
    assert "lizardfs_tpu" not in _tops(["lizardfs_tpu_torch.client.client"])
    assert "jax" not in _tops(["jaxlib_like"])


def test_the_runner_and_every_file_load_no_jax():
    files = []
    for d, _, names in os.walk(FSBENCH):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    code = (
        "import importlib.util, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import fsbench.run\n"
        # what a run loads of the program besides: the client, the daemons'
        # modules it builds, the encoder and the kernels' wrappers
        "import lizardfs_tpu_torch.client.client, lizardfs_tpu_torch.core.encoder\n"
        "import lizardfs_tpu_torch.ops.cuda_ec, lizardfs_tpu_torch.runtime.metrics\n"
        f"for i, path in enumerate({sorted(files)!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'_fsbench_file_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
    )
    tops = _tops(_loaded(code))
    for bad in ("jax", "jaxlib", "flax", "lizardfs_tpu"):
        assert bad not in tops, bad
    assert "lizardfs_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import fsbench.reference, fsbench.roofline, fsbench.data, fsbench.traffic\n"
    )
    tops = _tops(_loaded(code))
    for bad in ("jax", "lizardfs_tpu", "lizardfs_tpu_torch"):
        assert bad not in tops, bad


def test_the_runner_refuses_without_a_card():
    """No card: exit code 1 and no result line (the sandbox has none)."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "fsbench/run.py", "--workload", "ec8_4-degraded-read", "--seed", "3000000019",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1 and out.stdout == ""
