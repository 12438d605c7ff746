"""IAM for the S3 gateway, the port's copy of `seaweedfs_tpu/iam/`
(weed/s3api/auth_credentials.go, weed/iam/, weed/iamapi/, weed/kms/):

- identity:   Identity/Account/Credential, coarse S3 actions and the JSON
              identity store (the reference's s3.json shape, `-iamConfig`)
- sts:        stateless temporary credentials: session-token JWTs that
              any gateway holding the signing key verifies (`-stsKey`,
              `-rolesFile`)
- oidc:       OIDC id-token validation (HS256, RS256) for
              AssumeRoleWithWebIdentity
- iamapi:     the IAM REST API and STS AssumeRole over HTTP (`iam`)
- kms:        the local KMS provider and envelope encryption for SSE-KMS
              (`-kmsFile`; keys stay on the host)
- kms_aws:    the AWS KMS wire protocol (`-kmsEndpoint`) and its stub
- kms_cloud:  GCP KMS, Azure Key Vault and OpenBao transit
              (`-kmsCloud`), each with its fake server
- ldap:       an LDAP v3 client and provider over a from-scratch BER
              codec (the SFTP gateway's `-ldapServer`), and
              `MiniLdapServer`, the stand-in directory
"""

from .identity import (Account, Credential, Identity, IdentityStore,
                       coarse_action)
from .sts import StsService

__all__ = ["Account", "Credential", "Identity", "IdentityStore",
           "StsService", "coarse_action"]
