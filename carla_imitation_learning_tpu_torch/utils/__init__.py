"""Throughput counters (``profiling``), best-k checkpoints
(``checkpoint``) and metric sinks (``logging``, ``tb_writer``)."""
