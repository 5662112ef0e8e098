"""The elastic control plane of the port (counterpart of ``dt_tpu/elastic``):
the wire (``protocol``), the worker's client (``client``), the scheduler's
host-sync core and its data plane (``scheduler``, ``scheduler_main``,
``dataplane``, ``journal``), the ``dist_async`` server optimizers
(``server_optim``), the range servers of the sharded data plane
(``range_server``), seeded fault injection (``faults``) and the graceful
drain (``drain``).  Nothing here imports CUDA: the servers and the
client's threads are plain Python and numpy."""
