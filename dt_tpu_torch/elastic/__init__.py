"""The elastic control plane of the port (counterpart of ``dt_tpu/elastic``):
the wire (``protocol``), the worker's client (``client``), the scheduler's
host-sync core (``scheduler``, ``scheduler_main``, ``dataplane``,
``journal``), seeded fault injection (``faults``) and the graceful drain
(``drain``).  Nothing here imports CUDA: the scheduler and the client's
threads are plain Python and numpy."""
