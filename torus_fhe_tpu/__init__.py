"""torus_fhe_tpu — a TFHE framework in JAX/XLA.

Brand-new implementation of the full capability surface of the reference
Torus-FHE project (threshold TFHE in C++ + 3-generation multikey TFHE in
Julia), redesigned batch-first for accelerators: exact int8 matrix products replace
the f64 FFT, lax.scan replaces the CMux loop, one-hot matmuls replace
keyswitch gathers, and jax.sharding meshes replace OpenMP/Distributed.jl.
"""

from . import core, lwe, ops, rlwe, tgsw

__version__ = "0.1.0"
