"""The maintenance plane of erasure coding (weed/plugin, weed/worker;
the counterpart of `seaweedfs_tpu/plugin/`): the admin schedules jobs,
and a worker process registers, long-polls the admin over HTTP and runs
them.  The card enters the cluster here too: a worker's
`EcEncodeHandler` encodes on its own CUDA card (worker and batch
modes), and the rebuild and scatter jobs run on a volume server's.
"""

from .admin import AdminServer  # noqa: F401
from .handlers import EcEncodeHandler, EcRebuildHandler  # noqa: F401
from .worker import PluginWorker  # noqa: F401
