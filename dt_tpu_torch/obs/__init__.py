"""Observability of the port (counterpart of ``dt_tpu/obs``): the
training-health gates of ``metrics`` so far."""
