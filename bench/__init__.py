"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): ``run.py``
runs one cell of ``BENCHMARK.json``; the rest is its yardstick."""
