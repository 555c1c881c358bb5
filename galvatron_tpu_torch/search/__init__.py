"""Search of parallelism plans (the port of ``galvatron_tpu/search``)."""
