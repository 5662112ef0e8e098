"""Observability of the port (counterpart of ``dt_tpu/obs``): the tracer
(``trace``), the name catalog (``names``), the merged chrome-trace export
(``export``), the metrics and health plane (``metrics``), the flight
recorder (``blackbox``) and the device plane (``device``).  Only
``device`` touches torch, lazily, in worker-side functions."""
