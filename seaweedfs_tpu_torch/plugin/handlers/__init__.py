"""JobHandlers (weed/plugin/worker/*_handler.go): the erasure-coding
encode and rebuild handlers."""

from .erasure_coding import EcEncodeHandler, EcRebuildHandler  # noqa: F401
