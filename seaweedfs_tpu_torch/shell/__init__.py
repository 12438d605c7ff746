"""The shell's commands (weed/shell): lock, unlock, volume.list, the EC
verbs (ec.encode, ec.rebuild, ec.decode, ec.scrub, ec.balance), the
volume maintenance verbs (volume.vacuum, .balance, .move, .copy,
.fix.replication, .scrub, .merge and the rest of `commands.py` and
`admin_commands.py`), cluster.top, cluster.slow, cluster.profile,
trace.show and qos.*, reading every node's /metrics and debug routes;
and the `fs.*` family and the repair plane (volume.fsck,
volume.check.disk), driving a filer and the volume servers.  It imports
no torch."""

from . import admin_commands  # noqa: F401 — registers the volume admin verbs
from . import fs_commands  # noqa: F401 — registers the fs.* commands
from .commands import COMMANDS, CommandEnv, run_command  # noqa: F401
