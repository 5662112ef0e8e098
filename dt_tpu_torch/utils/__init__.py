"""Helpers: ``msgpack`` (no counterpart module in the JAX package) and
``profiler`` (``dt_tpu/utils/profiler.py`` on ``torch.profiler``)."""
