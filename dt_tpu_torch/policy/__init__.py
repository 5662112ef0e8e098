"""Policy arithmetic of the port (counterpart of ``dt_tpu/policy``): the
largest-remainder apportionment weighted data shards use."""
