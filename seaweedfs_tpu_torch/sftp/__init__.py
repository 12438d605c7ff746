"""SFTP gateway (reference: weed/sftpd/), the port's copy of
`seaweedfs_tpu/sftp/`: the same SSH transport, SFTP v3 op table and
user-store schema, so either package's client logs in to either
package's service and a store file written by one loads in the other.

The reference wraps golang.org/x/crypto/ssh + github.com/pkg/sftp and
adds the seaweed parts: a JSON user store with per-path permissions
(sftpd/user/filestore.go), password/publickey auth (sftpd/auth/), and
filer-backed file handlers (sftpd/sftp_filer.go).  No SSH library is
installed (no paramiko/asyncssh), so the transport itself is
implemented here from the RFCs:

- ssh_wire:   RFC 4251 types + RFC 4253 binary packet protocol
- transport:  version exchange, curve25519-sha256 kex (RFC 8731),
              ssh-ed25519 host keys, aes128-ctr + hmac-sha2-256,
              both server and client roles
- users:      user store (sftpd/user/user.go, filestore.go)
- handlers:   SFTP v3 op table over the filer (sftpd/sftp_filer.go)
- server:     accept loop + userauth + session channels + subsystem
- client:     minimal SSH/SFTP client (tests and `chip_smoke.py`)
"""

from .server import SftpService
from .users import User, UserStore

__all__ = ["SftpService", "User", "UserStore"]
