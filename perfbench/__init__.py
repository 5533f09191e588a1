"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one cell a
process (``run.py``), its cells, metrics and limits found by name
(``spec.py``)."""
