"""Benchmark of the PyTorch and CUDA port, ``clustering_tpu_torch``.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m bench_port.run --workload cli-10m --seed 1 --seconds 51 --trace 0

Everything that belongs to one configuration, traffic mix, entry or metric
sits in a file of its own under this folder, found by the name that
``BENCHMARK.json`` gives it (``configs/``, ``traffic/``, ``entries/``,
``metrics/``). The yardstick is here too: the input generator
(``fel.py``), the reduction of traces and logs (``trace.py``,
``stages.py``), the plain reference (``reference/``) and the comparisons
that decide ``correct`` (``checks/``, one a traffic mix names, and what
they share, ``check.py``). Nothing here imports ``jax`` or
the JAX package ``clustering_tpu``.
"""
