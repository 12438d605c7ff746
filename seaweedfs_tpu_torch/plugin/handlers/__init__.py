"""JobHandlers (weed/plugin/worker/*_handler.go): erasure-coding encode
and rebuild, vacuum, and the volume and EC-shard balances."""

from .balance import EcBalanceHandler, VolumeBalanceHandler  # noqa: F401
from .erasure_coding import EcEncodeHandler, EcRebuildHandler  # noqa: F401
from .vacuum import VacuumHandler  # noqa: F401
