"""The benchmark of ``lizardfs_tpu_torch``: one cell a run, driven by
``BENCHMARK.json`` at the checkout's root (see ``run.py``)."""
