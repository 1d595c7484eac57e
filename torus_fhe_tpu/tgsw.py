"""TGSW (gadget) samples and the external product.

Rework of 3-gen-mk-tfhe/src/tgsw.jl. A TGSW sample is the array of
(decomp_length, mask_size+1) RLWE samples; its "transformed" form here is
not an FFT image but the pre-packed int8 limb kernels consumed by the exact
int8 product (ops/poly.py) — the role the reference's
TransformedTGswSample plays for its FFT backend (tgsw.jl:47-55).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_dataclass

from .core.params import RLweParams, TGswParams
from .ops import poly
from .rlwe import RLweKey, RLweSample, rlwe_encrypt_zero


class TGswSample(NamedTuple):
    """Raw TGSW: samples[..., i, j, :, :] is RLWE row (i in l, j in k+1)."""

    samples: jax.Array  # (..., l, k+1, k+1, N) torus


@dataclass
class PackedTGsw:
    """Product-ready TGSW: int8 limb kernels for `negacyclic_extern_product`.

    kernels: (..., (k+1) * n_limbs, l*(k+1), N) int8 — out-features first,
    reduction rows (i, j) second, flipped window last.
    """

    kernels: jax.Array
    bits: int = 32
    mask_size: int = 1
    limb_offset: int = 0  # dropped low kernel limbs (BK compression)


register_dataclass(PackedTGsw, data_fields=("kernels",),
                   meta_fields=("bits", "mask_size", "limb_offset"))


def tgsw_encrypt(key, messages, alpha: float, rlwe_key: RLweKey,
                 tgsw_params: TGswParams, rlwe_params: RLweParams,
                 mask_round_bits: int = 0,
                 body_round_bits: int = 0) -> TGswSample:
    """Encrypt int messages (shape ``shape``) as TGSW samples.

    tgsw_encrypt_zero + message * gadget on the block diagonal
    (tgsw.jl:63-109). ``messages`` has any leading shape; output gains
    (l, k+1, k+1, N) trailing dims.

    Quantized-key generation (see rlwe_encrypt_zero): requires
    mask_round_bits <= bits - l*log2B so the gadget bumps (multiples of the
    smallest gadget value) preserve the mask's zero low bytes.
    """
    messages = jnp.asarray(messages)
    shape = messages.shape
    l = tgsw_params.decomp_length
    k = rlwe_params.mask_size
    if mask_round_bits:
        assert mask_round_bits <= tgsw_params.bits - l * tgsw_params.log2_base, \
            "mask quantum must divide the smallest gadget value"
    zero = rlwe_encrypt_zero(key, alpha, rlwe_key, rlwe_params, shape + (l, k + 1),
                             mask_round_bits=mask_round_bits,
                             body_round_bits=body_round_bits)
    a = zero.a  # (..., l, k+1, k+1, N)
    dtype = a.dtype
    gadget = jnp.asarray(tgsw_params.gadget_values, dtype)  # (l,)
    # add message * 1/B^i to poly j of RLWE row (i, j), constant coeff only
    msg = messages.astype(dtype)[..., None] * gadget  # (..., l)
    eye = jnp.eye(k + 1, dtype=dtype)  # delta_{j, poly}
    bump = msg[..., :, None, None] * eye  # (..., l, k+1, k+1)
    a = a.at[..., 0].add(bump)
    return TGswSample(a)


def pack_tgsw(sample: TGswSample, tgsw_params: TGswParams,
              drop_limbs: int = 0) -> PackedTGsw:
    """Host-side packing of TGSW samples into int8 limb kernels.

    The external product contracts decomposition digits (rows r = (i, j))
    against RLWE row polys producing k+1 output polys, so the kernel tensor is
    kernels[r=(i,j), c=poly] = samples[i, j, poly]. ``drop_limbs`` truncates
    the kernels' low bytes (BK compression, see poly.pack_kernels_host).
    """
    arr = np.asarray(jax.device_get(sample.samples))
    *lead, l, kp1, kp1_, N = arr.shape
    assert kp1 == kp1_
    kern = arr.reshape(*lead, l * kp1, kp1, N)  # (..., R, C, N)
    packed = poly.pack_kernels_host(kern, tgsw_params.bits, drop_limbs)
    return PackedTGsw(jnp.asarray(packed), tgsw_params.bits, kp1 - 1, drop_limbs)


def tgsw_decompose_rlwe(accum: RLweSample, tgsw_params: TGswParams):
    """Gadget-decompose all k+1 polys of a batch of RLWE samples into int8
    conv rows (tgsw.jl:112-138 + hcat in tgsw_extern_mul).

    accum.a: (B, k+1, N). Returns list of per-digit-limb row blocks, each
    (B, (k+1)*l, N) int8, ordered so row index = (i-th digit, j-th poly)
    matching `pack_tgsw`'s reduction layout.
    """
    digits = poly.decompose(
        accum.a, tgsw_params.decomp_length, tgsw_params.log2_base,
        tgsw_params.bits, tgsw_params.offset)  # (B, k+1, l, N) int32
    # reorder to (B, l, k+1, N) so rows = (i, j)
    digits = jnp.swapaxes(digits, -3, -2)
    blocks = poly.digits_to_i8_rows(digits, tgsw_params.log2_base)
    B = digits.shape[0] if digits.ndim == 4 else None
    out = []
    for blk in blocks:
        out.append(blk.reshape(blk.shape[:-3] + (-1, blk.shape[-1])))
    return out


def tgsw_extern_mul(accum: RLweSample, gsw: PackedTGsw, tgsw_params: TGswParams) -> RLweSample:
    """External product accum' = gsw (*) accum, exact (tgsw.jl:146-150).

    accum.a: (B, k+1, N); gsw.kernels: ((k+1)*limbs, l*(k+1), N).
    """
    row_blocks = tgsw_decompose_rlwe(accum, tgsw_params)
    kp1 = gsw.mask_size + 1
    total = None
    for m, rows in enumerate(row_blocks):
        prod = poly.negacyclic_extern_product(rows, gsw.kernels, gsw.bits, kp1,
                                              gsw.limb_offset)
        if m:
            prod = prod << (8 * m)
        total = prod if total is None else total + prod
    return RLweSample(total)
