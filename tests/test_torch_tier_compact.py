"""`volume.tier.compact` on the port, on the CPU: the JAX suite's test
(`test_shell_singles_r5.py::test_volume_tier_compact_reclaims_remote_space`)
on a port cluster (`jax_suite.load_suite`)."""

from jax_suite import load_suite, port_volume_server

PORTED = ("seaweedfs_tpu.s3", "seaweedfs_tpu.server.filer_server",
          "seaweedfs_tpu.server.master_server", "seaweedfs_tpu.filer",
          "seaweedfs_tpu.shell", "seaweedfs_tpu.storage")



globals().update(load_suite(
    "test_shell_singles_r5", PORTED, fixtures=("cluster",),
    overrides={"VolumeServer": port_volume_server},
    only=("test_volume_tier_compact_reclaims_remote_space",)))
