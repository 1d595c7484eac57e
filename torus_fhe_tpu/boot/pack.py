"""LWE -> RLWE ciphertext packing (a packing keyswitch).

The reference left this as a TODO — src/Convert.cpp:103: "TODO: Pack all 32
lwe ciphertexts into one tlwe ciphertext" (its `src/pack.cpp` is an empty
stub). This module implements it for real, batch-first: m <= N LWE ciphertexts
{(a_i, b_i)} under key s become ONE RLWE ciphertext whose phase polynomial
carries phase_i = b_i - <a_i, s> at coefficient i.

Construction (standard packing keyswitch): publish KSK_{j,r} = RLWE_S(s_j *
g_r) for every input key coefficient j and gadget level r. Then with
A_j(X) = sum_i a_{i,j} X^i and B(X) = sum_i b_i X^i,

    pack = (0, B) - sum_{j,r} g_r(A_j) (*) KSK_{j,r}

has phase B - sum_j A_j s_j - noise = sum_i phase_i X^i - noise: the
homomorphic payloads of all m inputs, packed.

The double sum is ONE exact int8 contraction — the same
negacyclic_extern_product machinery as the bootstrap (ops/poly.py), with
R = n*l reduction rows. Noise: sum of n*l digit-convolutions of the KSK
noise, sigma ~ sqrt(n*l*N*Var(d)) * alpha — a few 1e-3 at the 128-bit sizes,
far inside the 1/16 decode margin of +-1/8 messages.

Uses: ciphertext-size compression cloud->client (m LWEs of (n+1) words
become k*N+N words), and the repacking half of LWE<->RLWE conversion that
the threshold pipeline's TLweFromLwe (src/Convert.cpp:12-19) only
approximates one-sample-at-a-time.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_dataclass

from ..core.params import RLweParams, TGswParams
from ..lwe import LweKey, LweSample
from ..ops import poly
from ..rlwe import RLweKey, RLweSample, rlwe_encrypt_zero


@dataclass
class PackingKey:
    """kernels: conv-layout int8 limbs of the n*l KSK rows
    ((k+1)*limbs, n*l, N), from ops/poly.pack_kernels_host."""

    kernels: jax.Array
    n_in: int = 0
    decomp_length: int = 0
    log2_base: int = 0
    bits: int = 32
    mask_size: int = 1


register_dataclass(PackingKey, data_fields=("kernels",),
                   meta_fields=("n_in", "decomp_length", "log2_base", "bits",
                                "mask_size"))


def packing_keyswitch_keygen(key, alpha: float, lwe_key: LweKey,
                             rlwe_key: RLweKey, rlwe_params: RLweParams,
                             decomp_length: int = 3,
                             log2_base: int = 8) -> PackingKey:
    """KSK_{j,r} = RLWE_S(s_j * g_r): gadget encryptions of every input key
    coefficient under the ring key (host-side keygen, like tgsw_encrypt)."""
    assert log2_base <= 8, "int8 digit rows need byte-sized gadget digits"
    n = lwe_key.size
    bits = rlwe_params.bits
    tg = TGswParams(decomp_length, log2_base, bits)
    zero = rlwe_encrypt_zero(key, alpha, rlwe_key, rlwe_params,
                             (n, decomp_length))  # (n, l, k+1, N)
    a = np.array(jax.device_get(zero.a))  # writable copy
    npdt = a.dtype
    gadget = np.asarray(tg.gadget_values, npdt)  # (l,)
    s = np.asarray(jax.device_get(lwe_key.key), npdt)  # (n,)
    with np.errstate(over="ignore"):
        a[..., -1, 0] += s[:, None] * gadget[None, :]
    kern = a.reshape(n * decomp_length, a.shape[-2], a.shape[-1])  # (R, C, N)
    packed = poly.pack_kernels_host(kern, bits)
    return PackingKey(jnp.asarray(packed), n, decomp_length, log2_base, bits,
                      rlwe_params.mask_size)


def pack_lwes(pk: PackingKey, samples: LweSample, N: int) -> RLweSample:
    """Pack m <= N LWE samples into one degree-N RLWE sample.

    samples: a (..., m, n) / b (..., m). Returns RLweSample (..., k+1, N)
    whose phase coefficient i is the i-th input's phase (i >= m coefficients
    hold only packing noise).
    """
    tg = TGswParams(pk.decomp_length, pk.log2_base, pk.bits)
    dtype = jnp.int32 if pk.bits == 32 else jnp.int64
    a = jnp.asarray(samples.a, dtype)
    b = jnp.asarray(samples.b, dtype)
    *lead, m, n = a.shape
    assert n == pk.n_in and m <= N, (a.shape, pk.n_in, N)
    B = int(np.prod(lead)) if lead else 1

    # A_j(X) = sum_i a[i, j] X^i  ->  (B, n, N)
    A = jnp.swapaxes(a.reshape(B, m, n), -1, -2)
    A = jnp.pad(A, ((0, 0), (0, 0), (0, N - m)))
    digits = poly.decompose(A, tg.decomp_length, tg.log2_base, tg.bits,
                            tg.offset)  # (B, n, l, N)
    rows = digits.reshape(B, n * tg.decomp_length, N).astype(jnp.int8)

    delta = poly.negacyclic_extern_product(rows, pk.kernels, pk.bits,
                                           pk.mask_size + 1)  # (B, k+1, N)
    Bpoly = jnp.pad(b.reshape(B, m), ((0, 0), (0, N - m)))
    out = -delta
    out = out.at[:, -1].add(Bpoly)
    return RLweSample(out.reshape(tuple(lead) + out.shape[1:]) if lead
                      else out[0])
