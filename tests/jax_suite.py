"""Run a JAX package test file against the port.

`load_suite(name, ported)` executes `tests/<name>.py` with every module
path in `ported` rewritten from `seaweedfs_tpu` to `seaweedfs_tpu_torch`
(an entry may also be an import clause, `seaweedfs_tpu import security`),
so the servers and modules the suite drives are the port's while
everything else it imports stays the JAX package's.  It returns the
suite's tests under new names (`test_<short>__<name>`) and the fixtures
named in `fixtures`, to be bound into the importing test module, which
pytest then collects.  `overrides` replaces names in the executed
module after it ran (a JAX call signature the port spells otherwise),
`only`, when given, keeps just those of the suite's tests, and
`replace` swaps literal source text first (a subprocess's
`"-m", "seaweedfs_tpu"` argv for the port's).
`port_volume_server` stands in for the JAX `VolumeServer(dirs, master,
...)` as such an override.
"""

from __future__ import annotations

import os
import re
import types

HERE = os.path.dirname(os.path.abspath(__file__))


def port_volume_server(dirs, master, **kw):
    """The JAX suites' `VolumeServer(dirs, master, ...)` on a port volume
    server with the CPU codec."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    return VolumeServer(dirs, device="cpu", master=master, **kw)


def load_suite(name: str, ported, exclude=(), fixtures=(),
               overrides: "dict | None" = None, only=(),
               replace: "dict | None" = None) -> dict:
    path = os.path.join(HERE, f"{name}.py")
    with open(path) as f:
        src = f.read()
    for old, new in (replace or {}).items():
        if old not in src:
            raise ValueError(f"{name}: no {old!r} to replace")
        src = src.replace(old, new)
    for mod in ported:
        src = re.sub(rf"\b{re.escape(mod)}\b",
                     re.sub(r"^seaweedfs_tpu\b", "seaweedfs_tpu_torch", mod),
                     src)
    module = types.ModuleType(f"ported_{name}")
    module.__file__ = path
    exec(compile(src, path, "exec"), module.__dict__)
    for k, v in (overrides or {}).items():
        setattr(module, k, v)
    short = name.removeprefix("test_")
    out = {f"test_{short}__{k[5:]}": v
           for k, v in module.__dict__.items()
           if k.startswith("test_") and callable(v) and k not in exclude
           and (not only or k in only)}
    for k in fixtures:
        out[k] = module.__dict__[k]
    return out
