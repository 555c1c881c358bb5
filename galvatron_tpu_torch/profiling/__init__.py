"""Model and hardware profilers of the port (the counterpart of ``galvatron_tpu/profiling``)."""
