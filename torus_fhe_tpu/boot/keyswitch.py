"""LWE key switching as a one-hot int8 matmul.

The reference keyswitch (3-gen-mk-tfhe/src/keyswitch.jl:45-80) walks
n_in x decomp_length digit lookups per ciphertext, subtracting rows of a
(base-1, l, n_in) table of LWE samples. On an accelerator that access
pattern is a scattered gather from an ~80 MB table — hostile to HBM. Instead we express
the same sum as a dense matmul: a {0,1} one-hot matrix over (i, j, h) rows
times the byte-limb-packed table, so the whole batch of ciphertexts is one int8
matmul with exact int32 accumulation. Skipped h=0 rows contribute nothing, which
reproduces the reference's `if a[i,j] != 0` noise-free skip exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_dataclass

from ..core.params import KeyswitchParams, LweParams
from ..core import rng as trng
from ..lwe import LweKey, LweSample
from ..ops import poly


@dataclass
class KeyswitchKey:
    mat: jax.Array  # (n_in * l * (base-1), (n_out + 1) * 4) int8 limb table
    n_in: int = 0
    n_out: int = 0


register_dataclass(KeyswitchKey, data_fields=("mat",), meta_fields=("n_in", "n_out"))


def keyswitch_keygen(key, alpha: float, params: KeyswitchParams,
                     out_key: LweKey, in_key: LweKey) -> KeyswitchKey:
    """Generate the keyswitch table (keyswitch.jl:15-42).

    ks[i, j, h] = LWE_out( (s_in[i] * h) << (32 - j*log2_base) ) with
    re-centred gaussian noise. Packed host-side into the int8 matmul layout.
    """
    n_in = in_key.size
    n_out = out_key.size
    l = params.decomp_length
    base = 1 << params.log2_base
    ka, kn = jax.random.split(key)

    noise = trng.gaussian_float(kn, alpha, (n_in, l, base - 1))
    noise = noise - jnp.mean(noise)

    a = trng.uniform_torus(ka, (n_in, l, base - 1, n_out))

    s_in = in_key.key.astype(jnp.int32)  # (n_in,)
    h = jnp.arange(1, base, dtype=jnp.int32)  # (base-1,)
    j = jnp.arange(1, l + 1, dtype=jnp.int32)  # (l,)
    msg = (s_in[:, None, None] * h[None, None, :]) << (32 - j[None, :, None] * params.log2_base)

    from ..core.torus import double_to_torus

    b = msg + double_to_torus(noise, jnp.int32) + jnp.sum(a * out_key.key, axis=-1, dtype=jnp.int32)

    table = jnp.concatenate([a, b[..., None]], axis=-1)  # (n_in, l, base-1, n_out+1)
    table_np = np.asarray(jax.device_get(table)).reshape(n_in * l * (base - 1), n_out + 1)
    mat = poly.limb_split_signed_host(table_np, 32)  # (K, n_out+1, 4)
    mat = mat.reshape(mat.shape[0], -1)  # (K, (n_out+1)*4)
    return KeyswitchKey(jnp.asarray(mat), n_in, n_out)


def keyswitch(ks: KeyswitchKey, params: KeyswitchParams, sample: LweSample) -> LweSample:
    """Batched keyswitch (keyswitch.jl:45-80), one-hot matmul formulation.

    sample: batch of LWE over the input (extracted) key, a: (..., n_in) with
    any leading batch shape.
    """
    l = params.decomp_length
    lb = params.log2_base
    base = 1 << lb
    lead = sample.b.shape

    prec_offset = jnp.int32(1 << (32 - (1 + lb * l)))
    aibar = sample.a + prec_offset  # (..., n_in)

    j = np.arange(1, l + 1, dtype=np.int32)
    digits = (aibar[..., None] >> (32 - j * lb)) & (base - 1)  # (..., n_in, l)

    h = np.arange(1, base, dtype=np.int32)
    onehot = (digits[..., None] == h).astype(jnp.int8)  # (..., n_in, l, base-1)
    onehot = onehot.reshape(lead + (-1,))  # (..., K)

    deltas = jnp.dot(onehot, ks.mat, preferred_element_type=jnp.int32)
    deltas = deltas.reshape(lead + (ks.n_out + 1, 4))
    deltas = poly.limb_combine(deltas, 32, axis=-1)  # (..., n_out+1) int32

    return LweSample(-deltas[..., : ks.n_out], sample.b - deltas[..., ks.n_out])
