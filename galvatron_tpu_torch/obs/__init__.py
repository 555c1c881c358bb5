"""Step accounting of the port (``stepstats``)."""
