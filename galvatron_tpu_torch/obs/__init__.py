"""Step accounting of the port (``stepstats``) and the span tracer's interface (``tracing``)."""
