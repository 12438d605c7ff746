"""The shell's EC commands (weed/shell): lock, unlock, volume.list,
ec.encode, ec.rebuild, ec.decode and ec.scrub, driving a master and its
volume servers.  It imports no torch."""

from .commands import COMMANDS, CommandEnv, run_command  # noqa: F401
