"""Filer: a POSIX-ish namespace over the volume store (weed/filer), the
port's copy of `seaweedfs_tpu/filer/`.

Entries (directories and files) live in a FilerStore (memory or
sqlite); a file's content is a list of chunks, each a needle in some
volume.  Every mutation is committed to the store and appended to the
metadata log before it is acknowledged (the synchronous commit: the
JAX package's meta plane off).  It imports no torch.
"""

from .entry import Attributes, Entry, FileChunk  # noqa: F401
from .filer import Filer  # noqa: F401
from .filer_store import FilerStore, MemoryStore, SqliteStore  # noqa: F401
