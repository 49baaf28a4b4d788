"""pam_tpu: a cloud-resolving-model framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
E3SM-Project/PAM (the Portable Atmosphere Model used for E3SM-MMF
superparameterization): batched ensembles of limited-area nonhydrostatic
compressible atmosphere solvers with coupled column physics, built for
jit/vmap/shard_map over device meshes (one GPU or several).
"""

__version__ = "0.1.0"
