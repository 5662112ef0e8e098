"""Data iterators of the port (counterpart of ``dt_tpu/data``): the
in-memory and wrapper iterators of ``io``."""
