"""The benchmark of lrzip_next_tpu_torch (``python3 portbench/run.py``).

Its data files, generators, metric readers and plain reference are found
by the names in the checkout's ``BENCHMARK.json``; see ``core/cell.py``.
"""
