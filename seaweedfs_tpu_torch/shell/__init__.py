"""The shell's commands (weed/shell): lock, unlock, volume.list,
ec.encode, ec.rebuild, ec.decode and ec.scrub, driving a master and its
volume servers, and the `fs.*` family, driving a filer.  It imports no
torch."""

from . import fs_commands  # noqa: F401 — registers the fs.* commands
from .commands import COMMANDS, CommandEnv, run_command  # noqa: F401
