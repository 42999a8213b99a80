"""Throughput counters (``utils/profiling.py``)."""
