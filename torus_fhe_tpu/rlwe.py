"""Ring-LWE keys and samples over negacyclic polynomial rings.

Rework of 3-gen-mk-tfhe/src/rlwe.jl. An RLWE sample is stored as a
single array ``a`` of shape (..., k+1, N): mask polynomials 0..k-1 plus the
body polynomial at index k — mirroring the reference's mask_size+1 vector
(rlwe.jl:47-56) but flattened for vectorised math.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .core import rng as trng
from .core.params import RLweParams
from .core.torus import t64_to_t32
from .lwe import LweSample
from .ops import poly


class RLweKey(NamedTuple):
    key: jax.Array  # (k, N) small ints (binary or ternary)
    bits: int  # torus width this key encrypts (static)

    @property
    def mask_size(self) -> int:
        return self.key.shape[0]

    @property
    def polynomial_degree(self) -> int:
        return self.key.shape[-1]


class RLweSample(NamedTuple):
    a: jax.Array  # (..., k+1, N) torus; [..., :k, :] mask, [..., k, :] body

    def __add__(self, other):
        return RLweSample(self.a + other.a)

    def __sub__(self, other):
        return RLweSample(self.a - other.a)

    def __neg__(self):
        return RLweSample(-self.a)


def rlwe_keygen(key, params: RLweParams, negative: bool = False) -> RLweKey:
    """Binary (default) or negative-binary ternary key (rlwe.jl:17-29)."""
    sampler = trng.negative_binary if negative else trng.uniform_binary
    k = sampler(key, (params.mask_size, params.polynomial_degree))
    return RLweKey(k.astype(jnp.int32), params.bits)


def extract_lwe_key(rlwe_key: RLweKey):
    """Flatten the k ring-key polynomials into one LWE key of size k*N
    (rlwe.jl:33-40)."""
    from .lwe import LweKey

    return LweKey(rlwe_key.key.reshape(-1).astype(jnp.int32))


def rlwe_encrypt_zero(key, alpha: float, rlwe_key: RLweKey, params: RLweParams,
                      shape=(), mask_round_bits: int = 0,
                      body_round_bits: int = 0) -> RLweSample:
    """Homogeneous sample: mask uniform, body = sum_j s_j (*) a_j + noise
    (rlwe.jl:110-137).

    Keygen-only (never jitted): sampling happens in jax, the exact polynomial
    products on the host via ops/hostmath so arbitrarily large batches of
    zero-encryptions stay cheap and bit-exact.

    ``mask_round_bits``/``body_round_bits``: quantized-key generation — round
    the mask to multiples of 2^mask_round_bits BEFORE computing the body (so
    the sample stays an EXACT RLWE encryption whose mask low bytes are zero:
    the F-block layout then drops those limbs losslessly), and round the
    finished body to multiples of 2^body_round_bits (equivalent to extra body
    noise of stddev 2^body_round_bits/sqrt(12), ~sigma_bk for one byte).
    Security of the quantized mask is that of RLWE with modulus
    2^(bits-mask_round_bits) at unchanged absolute noise — a strictly larger
    noise-to-modulus ratio, i.e. a harder lattice instance.
    """
    import numpy as np

    from .ops import hostmath

    dtype = jnp.int32 if params.bits == 32 else jnp.int64
    npdt = np.int32 if params.bits == 32 else np.int64
    ka, kb = jax.random.split(key)
    k, N = params.mask_size, params.polynomial_degree
    a_mask = np.asarray(jax.device_get(trng.uniform_torus(ka, shape + (k, N), dtype)), npdt)
    if mask_round_bits:
        with np.errstate(over="ignore"):
            a_mask = ((a_mask + npdt(1 << (mask_round_bits - 1)))
                      >> mask_round_bits) << mask_round_bits
    noise = np.asarray(jax.device_get(trng.gaussian_torus(kb, 0, alpha, shape + (N,), dtype)), npdt)
    skey = np.asarray(jax.device_get(rlwe_key.key))
    body = noise
    for j in range(k):
        body = body + hostmath.negacyclic_polymul_host(skey[j], a_mask[..., j, :], params.bits)
    if body_round_bits:
        with np.errstate(over="ignore"):
            body = ((body + npdt(1 << (body_round_bits - 1)))
                    >> body_round_bits) << body_round_bits
    return RLweSample(jnp.asarray(np.concatenate([a_mask, body[..., None, :]], axis=-2)))


def rlwe_encrypt(key, mu, alpha: float, rlwe_key: RLweKey, params: RLweParams,
                 shape=()) -> RLweSample:
    """Symmetric ring-LWE encryption of message polys ``mu`` (..., N):
    zero-encryption plus mu on the body (tLweSymEncrypt; rlwe.jl homologue).
    Used by the threshold tlwetn flow (src/TLwe_TN.cpp:57-65)."""
    zero = rlwe_encrypt_zero(key, alpha, rlwe_key, params, shape)
    dtype = zero.a.dtype
    mu = jnp.broadcast_to(jnp.asarray(mu, dtype), shape + (params.polynomial_degree,))
    return RLweSample(zero.a.at[..., -1, :].add(mu))


def rlwe_noiseless_trivial(mu, params: RLweParams, shape=()) -> RLweSample:
    """(0, ..., 0, mu) (rlwe.jl:143-149). ``mu``: (..., N) torus polys."""
    dtype = jnp.int32 if params.bits == 32 else jnp.int64
    mu = jnp.broadcast_to(jnp.asarray(mu, dtype), shape + (params.polynomial_degree,))
    zeros = jnp.zeros(shape + (params.mask_size, params.polynomial_degree), dtype)
    return RLweSample(jnp.concatenate([zeros, mu[..., None, :]], axis=-2))


def rlwe_phase(sample: RLweSample, rlwe_key: RLweKey):
    """body - sum_j s_j (*) a_j, exact (decryption support)."""
    k = rlwe_key.mask_size
    dtype = sample.a.dtype
    skey = rlwe_key.key.astype(dtype)
    acc = sample.a[..., k, :]
    for j in range(k):
        acc = acc - poly.negacyclic_polymul_ref(skey[j], sample.a[..., j, :])
    return acc


def rlwe_extract_sample(sample: RLweSample) -> LweSample:
    """Constant-coefficient LWE extraction (rlwe.jl:64-75).

    a_lwe[(j, i)] = reverse-polynomial coefficients of mask j; b = body[0].
    For 64-bit samples, truncates phases to Torus32 like rlwe_extract_sample_64.
    """
    mask = sample.a[..., :-1, :]  # (..., k, N)
    body0 = sample.a[..., -1, 0]
    # reverse_polynomial: p(1/x) * x^N mod x^N+1 -> coeffs [p0, -p_{N-1}, ..., -p_1]
    rev = jnp.concatenate([mask[..., :1], -mask[..., :0:-1]], axis=-1)
    a = rev.reshape(rev.shape[:-2] + (-1,))
    if sample.a.dtype == jnp.int64:
        return LweSample(t64_to_t32(a), t64_to_t32(body0))
    return LweSample(a, body0)


def mul_by_monomial(sample: RLweSample, shift) -> RLweSample:
    """All polys times X^shift (rlwe.jl:160-161); shift may be per-batch."""
    return RLweSample(poly.mul_by_monomial(sample.a, shift))
