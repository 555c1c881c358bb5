"""The span tracer's interface, without a recorder: ``tracer.span(name,
**attrs)`` is a context manager that does nothing. The search engine opens
its spans through it (as the JAX package's does); span recording, flight
dumps and trace export are ROADMAP.md §1.12 'Observability'."""

from __future__ import annotations

import contextlib


class _Tracer:
    enabled = False

    def span(self, name: str, **attrs):
        """``with tracer.span("search_dp", pp=2): ...``; records nothing."""
        return contextlib.nullcontext()


tracer = _Tracer()
