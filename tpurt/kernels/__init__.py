"""Device kernels for the hot ops (SURVEY.md §1 L3/L4 kernel modules).

traverse — BVH nearest-hit search (packet + per-ray variants), plain
jnp/lax that XLA compiles for the GPU
"""
