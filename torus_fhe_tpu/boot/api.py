"""Single-key TFHE user API: keys, encrypt/decrypt.

Rework of 3-gen-mk-tfhe/src/api.jl:176-273 (SecretKey / CloudKey /
make_key_pair / encrypt / decrypt). Everything is batch-first: `encrypt` takes
an array of booleans and returns one batched LweSample pytree.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.params import SchemeParams
from ..core.torus import encode_message
from ..lwe import LweKey, LweSample, lwe_encrypt, lwe_keygen, lwe_phase
from ..rlwe import RLweKey, rlwe_keygen
from .bootstrap import BootstrapKey, bootstrap_keygen
from .keyswitch import KeyswitchKey, keyswitch_keygen


class SecretKey(NamedTuple):
    params: SchemeParams  # static (frozen dataclass)
    key: LweKey


class CloudKey(NamedTuple):
    params: SchemeParams
    bootstrap_key: BootstrapKey
    keyswitch_key: KeyswitchKey


def make_secret_key(key, params: SchemeParams) -> SecretKey:
    return SecretKey(params, lwe_keygen(key, params.lwe))


def make_cloud_key(key, secret_key: SecretKey, forms=("conv",),
                   fblock_device=None) -> CloudKey:
    """Bootstrapping + keyswitch keys from a fresh RLWE key (api.jl:225-245).

    ``forms`` selects the bootstrapping-key layout(s): "conv" (scan backend)
    and/or "fblock" (the fast block-circulant GEMM form; built on
    ``fblock_device``)."""
    params = secret_key.params
    k_rlwe, k_bk, k_ks = jax.random.split(key, 3)
    rlwe_key = rlwe_keygen(k_rlwe, params.rlwe)
    bk = bootstrap_keygen(k_bk, params.bs_noise_stddev, secret_key.key,
                          rlwe_key, params, forms=forms,
                          fblock_device=fblock_device)
    from ..rlwe import extract_lwe_key

    ks = keyswitch_keygen(k_ks, params.ks_noise_stddev, params.ks,
                          secret_key.key, extract_lwe_key(rlwe_key))
    return CloudKey(params, bk, ks)


def make_key_pair(key, params: SchemeParams, device=None, forms=("conv",)):
    """(secret, cloud) pair (api.jl:252-259).

    Keygen runs on the host CPU backend (its many small ops would each pay a
    launch on the accelerator) and ships the finished keys to ``device`` (default:
    the default accelerator) in one transfer. The F-block BK form (if
    requested) is built directly on the accelerator — only the compact TGSW
    samples cross the transfer boundary, not the expanded ~5.9 GB key.
    """
    from ..utils.device import cpu_device, on_host, to_device

    accel = jax.devices()[0].platform != "cpu"
    fb_dev = (device or jax.devices()[0]) if accel else None
    with on_host():
        # commit the PRNG key to the host CPU: an uncommitted key on the
        # default accelerator would pull every keygen op onto the device
        # (hundreds of small launches and transfers); committed-on-CPU
        # inputs keep the whole keygen graph on the host.
        key = jax.device_put(key, cpu_device())
        k1, k2 = jax.random.split(key)
        sk = make_secret_key(k1, params)
        ck = make_cloud_key(k2, sk, forms=forms, fblock_device=fb_dev)
    if accel:
        sk = to_device(sk, device)
        ck = to_device(ck, device)
    return sk, ck


def encrypt(key, secret_key: SecretKey, messages) -> LweSample:
    """Encrypt booleans as +-1/8 phases (api.jl:262-266)."""
    messages = jnp.asarray(messages)
    mu = jnp.where(messages, encode_message(1, 8), encode_message(-1, 8))
    return lwe_encrypt(key, mu, secret_key.params.lwe_noise_stddev,
                       secret_key.key, messages.shape)


def decrypt(secret_key: SecretKey, sample: LweSample):
    """Boolean decryption: positive phase = True (api.jl:269-273)."""
    return lwe_phase(sample, secret_key.key) > 0
