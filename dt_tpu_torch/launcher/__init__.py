"""The job launcher of the port (counterpart of ``dt_tpu/launcher``;
reference ``tools/launch.py``)."""

from dt_tpu_torch.launcher.launch import (launch_local as launch_local,
                                          launch_ssh as launch_ssh,
                                          main as main)
