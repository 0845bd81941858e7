"""The benchmark of ``uda_tpu_torch`` on one NVIDIA H100.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) for ``--seconds`` and prints one JSON line::

    python3 -m portbench.run --workload sort-tera-1e8 --seed 7 \\
        --seconds 10 --trace 0

Everything that belongs to one cell sits in a file of its own, found by
name: ``configs/<config>.json`` (the deployment), ``traffic/<mix>.json``
(the driver kind and its parameters), ``drivers/<kind>.py`` (the loop
that drives the port), ``metrics/<metric>.py`` (one reader a metric) and
``reference/<kind>.py`` (the plain check of the outputs, which imports
nothing of the port). ``gen.py``, ``ifile.py``, ``arith.py`` and
``trace.py`` are the benchmark's own generators, map-output writer,
metric arithmetic and profiler reading. Nothing here imports ``jax`` or
``uda_tpu``.
"""
