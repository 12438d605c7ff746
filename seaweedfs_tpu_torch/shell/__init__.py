"""The shell's commands (weed/shell): lock, unlock, volume.list, the EC
verbs (ec.encode, ec.rebuild, ec.decode, ec.scrub, ec.balance), the
volume maintenance verbs (volume.vacuum, .balance, .move, .copy,
.fix.replication, .scrub, .merge and the rest of `commands.py` and
`admin_commands.py`), cluster.top, cluster.slow, cluster.profile,
trace.show and qos.*, reading every node's /metrics and debug routes;
the `fs.*` family and the repair plane (volume.fsck,
volume.check.disk), driving a filer and the volume servers; and the
`remote.*` family, mounting foreign S3 stores into a filer; and the
`s3.*` family: buckets, quotas, lifecycle and the circuit breaker
through a filer, and the identities, keys, groups, policies and service
accounts of the identities JSON that the gateways and the IAM API
share.  It imports no torch."""

from . import admin_commands  # noqa: F401 — registers the volume admin verbs
from . import fs_commands  # noqa: F401 — registers the fs.* commands
from . import remote_commands  # noqa: F401 — registers the remote.* verbs
from . import s3_commands  # noqa: F401 — registers s3.* and s3tables.*
from . import s3_iam_commands  # noqa: F401 — registers the s3 identity verbs
from .commands import COMMANDS, CommandEnv, run_command  # noqa: F401
