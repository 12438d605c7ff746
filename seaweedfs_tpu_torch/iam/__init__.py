"""IAM for the S3 gateway, the port's copy of `seaweedfs_tpu/iam/`'s
identity model and local KMS (weed/s3api/auth_credentials.go,
weed/kms/local):

- identity:  Identity/Account/Credential, coarse S3 actions and the JSON
             identity store (the reference's s3.json shape, `-iamConfig`)
- kms:       the local KMS provider and envelope encryption for SSE-KMS
             (`-kmsFile`; keys stay on the host)

STS, OIDC, LDAP, the IAM API and the remote KMS providers are not
ported (ROADMAP A9).
"""

from .identity import (Account, Credential, Identity, IdentityStore,
                       coarse_action)

__all__ = ["Account", "Credential", "Identity", "IdentityStore",
           "coarse_action"]
