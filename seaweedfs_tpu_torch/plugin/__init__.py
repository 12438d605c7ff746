"""The maintenance plane (weed/plugin, weed/worker; the counterpart of
`seaweedfs_tpu/plugin/`): the admin schedules jobs and serves its UI,
and a worker process registers, long-polls the admin over HTTP and runs
them: EC encode and rebuild, vacuum, and the volume and EC balances.  The card enters the cluster here too: a worker's
`EcEncodeHandler` encodes on its own CUDA card (worker and batch
modes), and the rebuild and scatter jobs run on a volume server's.
"""

from .admin import AdminServer  # noqa: F401
from .handlers import (EcBalanceHandler, EcEncodeHandler,  # noqa: F401
                       EcRebuildHandler, VacuumHandler,
                       VolumeBalanceHandler)
from .worker import PluginWorker  # noqa: F401
