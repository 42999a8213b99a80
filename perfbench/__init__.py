"""The port's benchmark: ``python3 perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once and prints one JSON line.

Driven by data: a cell names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, whose ``kind`` picks the
general driver in ``kinds/``); the limits of its correctness check are in
``limits/<cell>.json``, and each per-layer metric is read by
``metrics/<metric>.py``. The plain reference is ``reference/``.
"""
