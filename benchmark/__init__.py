"""The benchmark of the PyTorch and CUDA port (``glass_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
driver, graph or subgraph recipe, plain reference, per-cell limit or
metric is a file of its own under ``configs/``, ``traffic/``, ``drivers/``,
``graphs/``, ``subgraphs/``, ``reference/``, ``limits/`` and ``metrics/``,
found by name. The yardstick (generators, the plain references, the
comparison, peaks, operation and byte counts, trace reduction) lives here
and imports nothing of JAX or of the JAX package.
"""
