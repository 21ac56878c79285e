"""The benchmark of ``deepsensornz_tpu_torch`` on one NVIDIA H100.

``run.py`` is the entry. Everything that belongs to one configuration,
one traffic mix, one cell's limits or one per-layer metric is a file of
its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py``. The yardstick
(input generation, work counts, trace reduction, the plain reference and
the comparison that decides ``correct``) lives here too; from the port the
benchmark takes only the system under test and its launch counters.
"""
