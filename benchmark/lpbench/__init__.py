"""The benchmark harness of ``ortools_tpu_torch``.

Everything that belongs to one configuration, traffic mix, generator,
traffic kind, metric or kernel is a file of its own under ``benchmark/``,
found by the name ``BENCHMARK.json`` or a configuration gives it
(``lpbench/spec.py``).  The harness drives the program through its public
entries only (``pdlp.solve``, ``mip.node_lp.PdhgNodeBackend``) and judges
what they return with the plain reference of ``benchmark/reference``.
"""
