"""Parallel and data-plane helpers of the port (counterpart of
``dt_tpu/parallel``): the 2-bit gradient compression, the single-device
``full_attention`` and the single-process kvstore so far."""
