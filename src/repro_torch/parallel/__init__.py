"""Sharded execution (port of `repro.parallel`): collectives and the
rank launcher (comm), logical-axis rules and the DPxTP(xEP) mesh (sharding),
the tensor-parallel quantized matmul (tp), the expert-parallel einsum and
MoE layer (ep)."""
