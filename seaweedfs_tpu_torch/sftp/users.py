"""SFTP user store (reference: weed/sftpd/user/user.go + filestore.go),
the port's copy of `seaweedfs_tpu/sftp/users.py`: one JSON schema for
both packages.

A JSON file of users, each with password and/or authorized public
keys, a home directory, per-path permission lists, and uid/gid for
file ownership — the same schema the reference's FileStore persists.
One deviation: passwords may be stored as `passwordSha256` (hex of
salt:hash) instead of the reference's plaintext `password`; both are
accepted so reference user files load unchanged.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets
import threading

# sftp_permissions.go permission vocabulary
PERM_READ = "read"
PERM_WRITE = "write"
PERM_LIST = "list"
PERM_DELETE = "delete"
PERM_MKDIR = "mkdir"
PERM_RENAME = "rename"
PERM_ALL = "*"

_WRITE_CLASS = {PERM_WRITE, PERM_DELETE, PERM_MKDIR, PERM_RENAME}


def _hash_password(password: str, salt: str | None = None) -> str:
    salt = salt or secrets.token_hex(8)
    digest = hashlib.sha256((salt + password).encode()).hexdigest()
    return f"{salt}:{digest}"


class User:
    """user/user.go User."""

    def __init__(self, username: str, home_dir: str = "",
                 uid: int | None = None, gid: int | None = None):
        self.username = username
        self.home_dir = home_dir or f"/home/{username}"
        # user.go NewUser: random 1000..60000 keeps out of system range
        rid = 1000 + secrets.randbelow(59000)
        self.uid = uid if uid is not None else rid
        self.gid = gid if gid is not None else self.uid
        self.password_plain = ""          # reference-compatible field
        self.password_hashed = ""         # salt:sha256 deviation
        self.public_keys: list[str] = []  # OpenSSH "ssh-ed25519 <b64>"
        self.permissions: dict[str, list[str]] = {}

    def set_password(self, password: str) -> None:
        self.password_hashed = _hash_password(password)
        self.password_plain = ""

    def check_password(self, password: str) -> bool:
        if self.password_hashed:
            salt, _ = self.password_hashed.split(":", 1)
            return hmac.compare_digest(
                _hash_password(password, salt), self.password_hashed)
        if self.password_plain:
            return hmac.compare_digest(self.password_plain, password)
        return False

    def add_public_key(self, key: str) -> None:
        key = " ".join(key.split()[:2])   # strip the comment field
        if key not in self.public_keys:
            self.public_keys.append(key)

    def has_public_key(self, alg: str, blob_b64: str) -> bool:
        return f"{alg} {blob_b64}" in self.public_keys

    # -- permissions (sftp_permissions.go CheckFilePermission) ------------

    def allowed(self, path: str, perm: str) -> bool:
        """sftp_permissions.go CheckFilePermission order: the home
        directory implicitly grants everything FIRST (so a broad "/"
        rule cannot lock a user out of their own home), then the most
        specific configured path containing `path` decides."""
        home = self.home_dir.rstrip("/")
        if home and (path == home or path.startswith(home + "/")):
            return True
        best, best_len = None, -1
        for p, perms in self.permissions.items():
            cp = p.rstrip("/") or "/"
            if path == cp or path.startswith(cp + "/") or cp == "/":
                if len(cp) > best_len:
                    best, best_len = perms, len(cp)
        if best is None:
            return False
        return PERM_ALL in best or perm in best or (
            "readwrite" in best and
            (perm in _WRITE_CLASS or perm in (PERM_READ, PERM_LIST)))

    def to_json(self) -> dict:
        return {"username": self.username, "homeDir": self.home_dir,
                "uid": self.uid, "gid": self.gid,
                "password": self.password_plain,
                "passwordSha256": self.password_hashed,
                "publicKeys": self.public_keys,
                "permissions": self.permissions}

    @classmethod
    def from_json(cls, d: dict) -> "User":
        u = cls(d["username"], d.get("homeDir", ""),
                d.get("uid"), d.get("gid"))
        u.password_plain = d.get("password", "")
        u.password_hashed = d.get("passwordSha256", "")
        u.public_keys = list(d.get("publicKeys", []))
        u.permissions = {k: list(v)
                         for k, v in d.get("permissions", {}).items()}
        return u


class UserStore:
    """user/filestore.go: load-at-start, save-on-mutate JSON store."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._users: dict[str, User] = {}
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            with open(path) as f:
                for d in json.load(f):
                    u = User.from_json(d)
                    self._users[u.username] = u

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump([u.to_json() for u in self._users.values()],
                          f, indent=1)
            os.replace(tmp, self.path)

    def get(self, username: str) -> User | None:
        return self._users.get(username)

    def put(self, user: User) -> None:
        self._users[user.username] = user
        self.save()

    def delete(self, username: str) -> None:
        self._users.pop(username, None)
        self.save()

    def __iter__(self):
        return iter(self._users.values())
