"""The benchmark of the PyTorch and CUDA port (``deepglobalregistration_tpu_torch``).

``python3 -m dgrbench.run --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once; see ``run.py``.
"""
