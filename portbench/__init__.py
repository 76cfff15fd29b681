"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

One run serves one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) for a fixed window and prints one JSON line::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that decides a number lives here, where changes to the program
cannot move it: the traffic generator (:mod:`portbench.traffic`), the
weights made from the seed (:mod:`portbench.weights`), the plain
references (``references/``), the comparison that decides ``correct``
(:mod:`portbench.check`), the peaks and the operation and byte counts
(:mod:`portbench.roofline`) and the profiler reader
(:mod:`portbench.devtrace`).  Configurations, traffic mixes and per-layer
metrics are files of their own (``configs/``, ``traffic/``, ``metrics/``),
found by the names ``BENCHMARK.json`` gives (:mod:`portbench.spec`).

Nothing here imports ``jax`` or the JAX package ``repro``.
"""
