"""The shell's `fs.*` family (weed/shell/command_fs_*.go), the port's
copy of the filer commands of `seaweedfs_tpu/shell/fs_commands.py`:
fs.configure, fs.ls, fs.cat, fs.meta, fs.rm, fs.mkdir, fs.du, fs.mv,
fs.tree, fs.pwd and fs.cd operate on a filer's namespace over its HTTP
surface.  The filer address comes from the shell's -filer flag or
`fs.configure`.  The output lines are the JAX shell's.
"""

from __future__ import annotations

import json
import urllib.parse

from ..server.httpd import http_bytes, http_json
from .commands import CommandEnv, _parse_flags, command


def _filer_get(env: CommandEnv, path: str, query: str = ""):
    url = env.require_filer() + urllib.parse.quote(path)
    if query:
        url += "?" + query
    return http_bytes("GET", url)


# --- fs.* family ---------------------------------------------------------

@command("fs.configure")
def cmd_fs_configure(env: CommandEnv, args: list[str]) -> str:
    opts = _parse_flags(args)
    if "filer" in opts:
        env.filer = opts["filer"]
    return f"filer = {env.filer or '(unset)'}"


def _list_dir(env: CommandEnv, path: str) -> list[dict]:
    """Full listing with lastFileName pagination (a silent truncation
    would hide entries from ls, du and tree)."""
    out: list[dict] = []
    last = ""
    while True:
        st, body, _ = _filer_get(
            env, path.rstrip("/") + "/",
            "limit=1000&lastFileName=" + urllib.parse.quote(last))
        if st != 200:
            raise RuntimeError(f"list {path}: HTTP {st}")
        batch = json.loads(body).get("entries", [])
        out.extend(batch)
        if len(batch) < 1000:
            return out
        last = batch[-1]["fullPath"].rsplit("/", 1)[-1]


@command("fs.ls")
def cmd_fs_ls(env: CommandEnv, args: list[str]) -> str:
    """command_fs_ls.go: list a directory (-l for mode/size/mtime)."""
    opts = _parse_flags(args)
    paths = [a for a in args if not a.startswith("-")] or ["/"]
    out = []
    for path in paths:
        for e in _list_dir(env, path):
            name = e["fullPath"].rsplit("/", 1)[-1]
            if e.get("isDirectory"):
                name += "/"
            if "l" in opts:
                attrs = e.get("attributes", {})
                size = sum(c.get("size", 0)
                           for c in e.get("chunks", []))
                out.append(f"{attrs.get('mode', 0):>6o} "
                           f"{size:>12} {name}")
            else:
                out.append(name)
    return "\n".join(out)


@command("fs.cat")
def cmd_fs_cat(env: CommandEnv, args: list[str]) -> str:
    """command_fs_cat.go."""
    path = next(a for a in args if not a.startswith("-"))
    st, body, _ = _filer_get(env, path)
    if st != 200:
        raise RuntimeError(f"cat {path}: HTTP {st}")
    return body.decode(errors="replace")


@command("fs.meta")
def cmd_fs_meta(env: CommandEnv, args: list[str]) -> str:
    """command_fs_meta_cat.go: raw entry metadata incl. chunk fids."""
    path = next(a for a in args if not a.startswith("-"))
    st, body, _ = http_bytes(
        "GET", f"{env.require_filer()}/__meta__/lookup?path="
        f"{urllib.parse.quote(path)}")
    if st != 200:
        raise RuntimeError(f"meta {path}: HTTP {st}")
    return json.dumps(json.loads(body), indent=2)


@command("fs.rm")
def cmd_fs_rm(env: CommandEnv, args: list[str]) -> str:
    """command_fs_rm.go (-r recursive)."""
    opts = _parse_flags(args)
    targets = [a for a in args if not a.startswith("-")]
    removed = []
    for path in targets:
        rec = "?recursive=true" if "r" in opts else ""
        st, body, _ = http_bytes(
            "DELETE",
            env.require_filer() + urllib.parse.quote(path) + rec)
        if st not in (204, 200):
            raise RuntimeError(
                f"rm {path}: HTTP {st} {body[:200]!r}")
        removed.append(path)
    return f"removed: {removed}"


@command("fs.mkdir")
def cmd_fs_mkdir(env: CommandEnv, args: list[str]) -> str:
    path = next(a for a in args if not a.startswith("-"))
    st, _, _ = http_bytes(
        "PUT", env.require_filer() + urllib.parse.quote(
            path.rstrip("/") + "/"))
    if st not in (200, 201):
        raise RuntimeError(f"mkdir {path}: HTTP {st}")
    return f"created {path}"


@command("fs.du")
def cmd_fs_du(env: CommandEnv, args: list[str]) -> str:
    """command_fs_du.go: recursive size of a subtree."""
    path = (next((a for a in args if not a.startswith("-")), "/"))

    def du(p: str) -> "tuple[int, int]":
        nbytes = nfiles = 0
        for e in _list_dir(env, p):
            if e.get("isDirectory"):
                b, f = du(e["fullPath"])
                nbytes += b
                nfiles += f
            else:
                nbytes += sum(c.get("size", 0)
                              for c in e.get("chunks", []))
                nfiles += 1
        return nbytes, nfiles

    nbytes, nfiles = du(path)
    return f"{nbytes} bytes, {nfiles} files under {path}"


@command("fs.mv")
def cmd_fs_mv(env: CommandEnv, args: list[str]) -> str:
    """command_fs_mv.go: rename/move within the filer namespace via
    the atomic rename RPC (filer.proto AtomicRenameEntry)."""
    paths = [a for a in args if not a.startswith("-")]
    if len(paths) != 2:
        raise RuntimeError("usage: fs.mv <source> <destination>")
    src, dst = paths
    r = http_json("POST", env.require_filer() + "/__meta__/rename",
                  {"oldPath": src, "newPath": dst})
    if "error" in r:
        raise RuntimeError(f"fs.mv: {r['error']}")
    return f"moved {src} -> {dst}"


@command("fs.tree")
def cmd_fs_tree(env: CommandEnv, args: list[str]) -> str:
    """command_fs_tree.go: recursive listing as an indented tree."""
    paths = [a for a in args if not a.startswith("-")] or ["/"]
    root = paths[0]
    lines: list[str] = [root]
    dirs = files = 0

    def walk(path: str, depth: int) -> None:
        nonlocal dirs, files
        for e in _list_dir(env, path):
            name = e["fullPath"].rsplit("/", 1)[-1]
            is_dir = e.get("isDirectory")
            lines.append("  " * (depth + 1) +
                         (name + "/" if is_dir else name))
            if is_dir:
                dirs += 1
                walk(e["fullPath"], depth + 1)
            else:
                files += 1

    walk(root.rstrip("/") or "/", 0)
    lines.append(f"{dirs} directories, {files} files")
    return "\n".join(lines)


# --- the shell's working directory (command_fs_cd.go, _pwd) -------------

def _resolve(env: CommandEnv, path: str) -> str:
    """Resolve against the shell's working directory (fs.cd),
    collapsing ./.. segments so `fs.cd ..` navigates up."""
    import posixpath
    cwd = getattr(env, "cwd", "/")
    if not path:
        return cwd
    if not path.startswith("/"):
        path = cwd.rstrip("/") + "/" + path
    return posixpath.normpath(path) or "/"


@command("fs.pwd")
def cmd_fs_pwd(env: CommandEnv, args: list[str]) -> str:
    """command_fs_pwd.go."""
    return getattr(env, "cwd", "/")


@command("fs.cd")
def cmd_fs_cd(env: CommandEnv, args: list[str]) -> str:
    """command_fs_cd.go: change the shell's filer working directory
    (relative fs.* paths resolve against it)."""
    target = _resolve(env, args[0] if args else "/")
    if target != "/":
        st, body, _ = _filer_get(
            env, "/__meta__/lookup",
            "path=" + urllib.parse.quote(target.rstrip("/")))
        if st != 200 or not json.loads(body).get("isDirectory"):
            raise RuntimeError(f"{target}: not a directory")
    env.cwd = target if target.startswith("/") else "/" + target
    return env.cwd
