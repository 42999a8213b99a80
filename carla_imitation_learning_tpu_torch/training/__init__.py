"""Closed loop and collection (``closed_loop``), BC losses, train steps and
the ``Trainer`` (``losses``, ``steps``, ``loop``)."""
