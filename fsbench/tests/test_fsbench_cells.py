"""Every cell's whole path at a tiny size on the CPU: a real cluster of
daemon processes, the mount on the numpy encoder (named explicitly: the
measured path refuses to run without a card), the window, and the
comparison with the reference. Then each control and fault is put in the
program's place and ``correct`` has to come out false."""

import asyncio

import pytest

from fsbench import controls, manifest, run

BENCH = manifest.load()
SEED = 3_000_000_019
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(cell: str) -> dict:
    p = manifest.traffic(manifest.workload(BENCH, cell)["traffic"])
    p.update(files=3, file_bytes=3 << 20, readers=2, size_min=4096,
             size_max=512 << 10, warmup_reads=4, check_share=0.5)
    return p


def run_cell(cell: str, control=None, trace_on=False) -> run.Cell:
    c = run.Cell(BENCH, cell, SEED, 1.5, trace_on=trace_on, device="cpu",
                 control=control, client_encoder="cpu", params=tiny(cell))
    asyncio.run(c.run())
    return c


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell):
    c = run_cell(cell, trace_on=True)
    res = c.result()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["metrics"], "a traced run reads per-layer metrics"
    for name in res["metrics"]:
        assert name in {m["name"] for m in manifest.per_layer(BENCH, cell)}
    if "kill" in c.params:
        assert c.notes["killed"]["data_parts"] > 0
        assert {"degraded_chunks_at_end", "parts_rebuilt"} <= set(res["checks"])
    assert c.notes["host_probe_ms"] > 0 and c.notes["mount_threads_cpu_s"]


@pytest.mark.parametrize("cell,control", [(c, x) for c in CELLS
                                          for x in controls.CONTROLS + controls.FAULTS])
def test_control_is_not_correct(cell, control):
    assert not run_cell(cell, control).result()["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_end_to_end_line(cell):
    res = run_cell(cell).result()
    assert set(res["metrics"]) == {m["name"] for m in manifest.end_to_end(BENCH, cell)}
    assert all(v["value"] > 0 for v in res["metrics"].values())
