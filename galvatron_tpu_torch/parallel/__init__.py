"""Single-device training runtime of the port (``hybrid.build_runtime``)."""
