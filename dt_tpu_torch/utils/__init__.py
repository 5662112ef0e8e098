"""Helpers with no counterpart module in ``dt_tpu`` (``msgpack``)."""
