"""The benchmark of the PyTorch and CUDA port (``ompi_tpu_torch``).

``benchmark/run.py`` runs one cell of ``BENCHMARK.json``; see
``benchmark/README.md``.
"""
