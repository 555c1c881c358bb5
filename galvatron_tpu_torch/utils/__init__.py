"""Thread-safe serving metrics of the port."""
