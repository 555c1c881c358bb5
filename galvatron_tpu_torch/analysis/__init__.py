"""The static plan checker of the port (``plan_check``, ``diagnostics``)."""
