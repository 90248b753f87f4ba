"""Multi-device training on torch.distributed (the JAX package's
parallel/): ``mesh`` (MeshContext, the collectives, --fsdp's state rule),
``launch`` (starting the ranks), ``dryrun`` (one DP step over N CPU
ranks)."""

from csl_gan_tpu_torch.parallel.mesh import MeshContext, fsdp_spec, state_spec  # noqa: F401
