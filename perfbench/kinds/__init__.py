"""General drivers of the traffic mixes, one per ``kind``: ``setup(...)``
returns an object whose ``call()`` runs one timed call of the port."""
