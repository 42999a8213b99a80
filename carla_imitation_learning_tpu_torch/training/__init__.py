"""Closed-loop rollout and evaluation (``training.closed_loop``)."""
