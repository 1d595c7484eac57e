"""3rd-generation (AKÖ) multikey TFHE key material.

Rework of the AKÖ scheme's keygen pipeline
(3-gen-mk-tfhe/src/mk_internals.jl:177-345, src/tgsw_3gen.jl:3-98,
src/3gen_mk_internals.jl:10-55, demo pipeline multikey_3gen.jl:15-32):

  CRP a  →  per-party pubkey b_p = s_p ⊛ a + e  →  common pubkey b = Σ_p b_p
         →  per-party BK part: TGSW_3gen(LWE key bits) under (b, a)
         →  per-party keyswitch key  extract(s_p) → lwe_p.

The AKÖ 4-part TGSW sample (part_1..part_4, tgsw_3gen.jl:3-18) is packed here
as a standard TGSW kernel tensor of shape (l, 2, 2, N):

    samples[i, j=mask]  = (part_3[i], part_2[i])
    samples[i, j=body]  = (part_4[i], part_1[i])

so the 3gen external product (tgsw_3gen.jl:102-113) IS the single-key external
product of ops/poly.py — c1' = Σ g(c1)⊛part3 + g(c0)⊛part4, c0' = Σ g(c1)⊛part2
+ g(c0)⊛part1 — and the whole exact int8 blind-rotate machinery is reused with
parties × n CMux steps. All keygen math runs host-side (exact limb FFT) and
ships packed int8 kernels to the device once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_dataclass

from ..boot.keyswitch import KeyswitchKey, keyswitch_keygen
from ..core import rng as trng
from ..core.params import SchemeParams3Gen
from ..lwe import LweKey, lwe_keygen
from ..ops import hostmath, poly
from ..rlwe import RLweKey, extract_lwe_key, rlwe_keygen
from ..utils.device import on_host, to_device


class CRP(NamedTuple):
    """Common random polynomials: l uniform torus polys (CRP_3gen,
    mk_internals.jl:177-196). ``a_same=True`` repeats one poly l times."""

    a: jax.Array  # (l, N) torus


def gen_crp(key, params: SchemeParams3Gen, a_same: bool = True) -> CRP:
    dtype = jnp.int32 if params.rlwe_bits == 32 else jnp.int64
    l, N = params.gsw_decomp_length, params.rlwe_polynomial_degree
    if a_same:
        one = trng.uniform_torus(key, (1, N), dtype)
        return CRP(jnp.broadcast_to(one, (l, N)))
    return CRP(trng.uniform_torus(key, (l, N), dtype))


class PublicKeyPart(NamedTuple):
    """Party p's public key b_p[i] = s_p ⊛ a[i] + e (PublicKey,
    mk_internals.jl:265-305)."""

    b: jax.Array  # (l, N) torus


def public_keygen(key, rlwe_key: RLweKey, crp: CRP,
                  params: SchemeParams3Gen) -> PublicKeyPart:
    a = np.asarray(jax.device_get(crp.a))
    s = np.asarray(jax.device_get(rlwe_key.key[0]))
    prod = hostmath.negacyclic_polymul_host(s, a, params.rlwe_bits)
    dtype = jnp.int32 if params.rlwe_bits == 32 else jnp.int64
    noise = trng.gaussian_torus(key, 0, params.gsw_noise_stddev, a.shape, dtype)
    return PublicKeyPart(jnp.asarray(prod) + noise)


def common_public_key(pubkeys: Sequence[PublicKeyPart]) -> PublicKeyPart:
    """b = Σ_p b_p (CommonPubKey_3gen, mk_internals.jl:325-345)."""
    total = pubkeys[0].b
    for pk in pubkeys[1:]:
        total = total + pk.b
    return PublicKeyPart(total)


def tgsw_encrypt_3gen(key, messages, common_b, crp_a, params: SchemeParams3Gen):
    """AKÖ uni-encryption of int messages under the common pubkey
    (tgsw_encrypt_3gen, tgsw_3gen.jl:42-98), vectorised over messages.

    messages: (M,) ints. Returns the standard-TGSW-layout kernel tensor
    (M, l, 2, 2, N) ready for pack_tgsw.
    """
    M = int(np.shape(messages)[0])
    l, N = params.gsw_decomp_length, params.rlwe_polynomial_degree
    bits = params.rlwe_bits
    npdt = np.int32 if bits == 32 else np.int64
    k1, k2, k3 = jax.random.split(key, 3)
    r1 = np.asarray(jax.device_get(trng.negative_binary(k1, (M, l, N))), np.int32)
    r2 = np.asarray(jax.device_get(trng.negative_binary(k2, (M, l, N))), np.int32)
    dtype = jnp.int32 if bits == 32 else jnp.int64
    errs = np.asarray(jax.device_get(trng.gaussian_torus(
        k3, 0, params.gsw_noise_stddev, (4, M, l, N), dtype)), npdt)

    b = np.asarray(jax.device_get(common_b), npdt)  # (l, N)
    a = np.asarray(jax.device_get(crp_a), npdt)  # (l, N)
    r1b = hostmath.negacyclic_polymul_host(r1, b, bits)
    r2b = hostmath.negacyclic_polymul_host(r2, b, bits)
    r1a = hostmath.negacyclic_polymul_host(r1, a, bits)
    r2a = hostmath.negacyclic_polymul_host(r2, a, bits)

    from ..core.params import TGswParams

    gadget = np.asarray(TGswParams(l, params.gsw_log2_base, bits).gadget_values, npdt)
    msg = np.asarray(messages, npdt)  # (M,)
    bump = msg[:, None] * gadget  # (M, l) added to the constant coefficient

    part1 = r1b + errs[0]
    part1[..., 0] += bump
    part2 = r2b + errs[1]
    part3 = r2a + errs[2]
    part3[..., 0] += bump
    part4 = r1a + errs[3]

    # standard-TGSW kernel layout: samples[i, j, c]; j=0 decomposes the mask
    # (c1), j=1 the body (c0); c=0 mask output, c=1 body output.
    samples = np.empty((M, l, 2, 2, N), npdt)
    samples[:, :, 0, 0] = part3
    samples[:, :, 0, 1] = part2
    samples[:, :, 1, 0] = part4
    samples[:, :, 1, 1] = part1
    return samples


@dataclass
class MKCloudKey:
    """Assembled multikey cloud key (MKCloudKey, mk_api.jl:440-474):
    packed blind-rotate kernels over parties×n CMux steps plus the stacked
    per-party keyswitch tables.

    ``bk_fb`` is the fast form: the 64-bit-torus BK *hi-word rounded* to
    Torus32 granularity and laid out as a 32-bit F-block key (see
    hi_round_samples) — drives the F-block GEMM scan. ``bk_fb_sel`` is the
    COMPACT fast form (ops/fblock.build_sel): the same rounded key as
    extended limb lines, ~256x smaller, expanded on the fly per step chunk
    (ops/fblock.blind_rotate_streamed) — the form that gives >=4-party
    production sets a fast path on ONE chip (their expanded keys exceed
    HBM: parallel/mk_pipeline.py). ``bk_samples`` keeps the compact raw
    TGSW samples for serialization (utils/serialize)."""

    bk_kernels: jax.Array = None  # (parties*n, 2*limbs, l*2, N) int8
    ks_mat: jax.Array = None  # (K, parties*(n+1)*4) int8 — party-concat tables
    parties: int = 1
    params: SchemeParams3Gen = None
    bk_fb: jax.Array = None  # (parties*n, D*R*bs, 8*bs) int8, 32-bit geometry
    bk_samples: jax.Array = None  # (parties*n, l, 2, 2, N) torus64
    bk_fb_sel: jax.Array = None  # (parties*n, R, 2N, ncols) int8 compact


register_dataclass(MKCloudKey,
                   data_fields=("bk_kernels", "ks_mat", "bk_fb", "bk_samples",
                                "bk_fb_sel"),
                   meta_fields=("parties", "params"))


def mk_fb_supported(params: SchemeParams3Gen) -> bool:
    """The hi-word F-block trick needs every gadget value to be a multiple of
    2^32 (l*log2B <= 31, so Torus32 rounding commutes with the gadget) AND
    small digits (log2B <= 8): the +-2^-33 rounding of each BK entry is
    amplified by digit magnitude B/2 in every product, so Bg=2^26 sets would
    take ~2^17x the rounding noise and flip decryptions (measured — the
    wide-digit sets use the exact 64-bit streamed form instead, see
    mk_cloud_keygen)."""
    l, B = params.gsw_decomp_length, params.gsw_log2_base
    return params.rlwe_bits == 64 and l * B <= 31 and B <= 8


def mk_fb_stream_supported(params: SchemeParams3Gen) -> bool:
    """The streamed compact F-block form covers EVERY 3gen set: hi-word
    32-bit lines when mk_fb_supported, else exact 64-bit lines (no rounding,
    wide digits split into shift-combined int8 blocks)."""
    return params.rlwe_bits == 64


def mk_fb_geometry(params: SchemeParams3Gen, parties: int):
    """32-bit (hi-word) F-block geometry over the parties*n CMux steps."""
    from ..ops import fblock

    return fblock.fblock_geometry(
        parties * params.lwe_size, params.rlwe_polynomial_degree,
        params.rlwe_mask_size, params.gsw_decomp_length, 32, 0)


def mk_fb64_geometry(params: SchemeParams3Gen, parties: int):
    """Exact 64-bit F-block geometry (16 limb columns) — the streamed form
    for wide-digit (Bg > 2^8) sets where hi-word rounding is noise-unsafe."""
    from ..ops import fblock

    return fblock.fblock_geometry(
        parties * params.lwe_size, params.rlwe_polynomial_degree,
        params.rlwe_mask_size, params.gsw_decomp_length, 64, 0)


def hi_round_samples(samples: np.ndarray) -> np.ndarray:
    """Round Torus64 TGSW samples to the nearest multiple of 2^32 and keep the
    top word as Torus32.

    When l*log2B <= 31 every gadget value, the decomposition offset, and the
    [mu..mu] test vector are multiples of 2^32, so the entire 64-bit blind
    rotate over the rounded key IS a 32-bit computation in the hi word —
    bit-exactly (tests/test_mk3gen.py asserts this against the 64-bit scan on
    the same rounded key). The rounding itself perturbs each BK entry by
    uniform +-2^-33, i.e. sigma = 2^-32/sqrt(12) ~ 0.15x the sets' own
    sigma_bk = 2^-30.7 — a ~1% noise-stddev increase, measured in
    measurements/ (VERDICT r2 item 3 methodology)."""
    u = np.asarray(samples).astype(np.uint64)
    return ((u + (1 << 31)) >> np.uint64(32)).astype(np.uint32).view(np.int32)


class MKSecretKey(NamedTuple):
    """One party's secret material (SecretKey_3gen + RLweKey,
    api.jl:196-204, multikey_3gen.jl:15-17)."""

    lwe: LweKey
    rlwe: RLweKey


def mk_party_keygen(key, params: SchemeParams3Gen) -> MKSecretKey:
    k1, k2 = jax.random.split(key)
    with on_host():
        lwe = lwe_keygen(k1, params.lwe)
        rlwe = rlwe_keygen(k2, params.rlwe, negative=True)
    return MKSecretKey(lwe, rlwe)


def mk_cloud_keygen(key, secret_keys: Sequence[MKSecretKey],
                    params: SchemeParams3Gen, device=None,
                    forms=("conv",), keep_samples: bool = False) -> MKCloudKey:
    """Full AKÖ cloud-key pipeline (multikey_3gen.jl:19-32):
    CRP → pubkeys → common pubkey → per-party BK parts (packed) → KSKs.

    ``forms``: "conv" packs the scan-backend kernels; "fblock" additionally
    builds the hi-word-rounded 32-bit F-block key (the fast path; requires
    mk_fb_supported(params)); "fbstream" builds the compact
    fast form instead (expanded per step chunk at rotate time — REQUIRED for
    >=4-party production sets whose expanded key exceeds one chip's HBM).
    ``keep_samples`` retains the compact raw samples for serialization."""
    from ..core.params import TGswParams
    from ..ops import fblock

    parties = len(secret_keys)
    assert parties <= params.max_parties
    if params.rlwe_bits == 64:
        # without x64 the JAX-side samplers silently truncate to int32 and
        # the key degenerates to a near-zero mask (insecure). Keygen needs
        # x64; x64-free *evaluation* is fine via a serialized key + the
        # hi-word fast path.
        assert jax.config.jax_enable_x64, \
            "64-bit MK keygen requires jax_enable_x64=True"
    if "fblock" in forms:
        assert mk_fb_supported(params), \
            "fblock form needs l*log2B <= 31 and log2B <= 8 (use fbstream)"
    if "fbstream" in forms:
        assert mk_fb_stream_supported(params)
    with on_host():
        kc, kb, kk = jax.random.split(key, 3)
        crp = gen_crp(kc, params)
        pubs = [public_keygen(jax.random.fold_in(kb, 1000 + p), sk.rlwe, crp, params)
                for p, sk in enumerate(secret_keys)]
        common = common_public_key(pubs)

        tgsw_params = TGswParams(params.gsw_decomp_length, params.gsw_log2_base,
                                 params.rlwe_bits)
        kernels = []
        all_samples = []
        for p, sk in enumerate(secret_keys):
            bits = np.asarray(jax.device_get(sk.lwe.key), np.int64)
            samples = tgsw_encrypt_3gen(jax.random.fold_in(kb, p), bits,
                                        common.b, crp.a, params)
            all_samples.append(samples)
            if "conv" in forms:
                # pack each key bit's TGSW into int8 limb kernels
                kern = samples.reshape(samples.shape[0],
                                       samples.shape[1] * 2, 2,
                                       samples.shape[-1])
                kernels.append(poly.pack_kernels_host(kern, params.rlwe_bits))
        bk = np.concatenate(kernels, axis=0) if kernels else None

        mats = []
        for p, sk in enumerate(secret_keys):
            ks = keyswitch_keygen(jax.random.fold_in(kk, p), params.ks_noise_stddev,
                                  params.ks, sk.lwe, extract_lwe_key(sk.rlwe))
            mats.append(np.asarray(jax.device_get(ks.mat)))
        # (K, parties*(n+1)*4): one shared one-hot, party-concatenated outputs
        ks_mat = np.concatenate(mats, axis=1)

    samples_cat = np.concatenate(all_samples, axis=0)  # (parties*n, l, 2, 2, N)
    fb = fb_sel = None
    if "fblock" in forms or "fbstream" in forms:
        ctx = jax.default_device(device) if device is not None else _nullctx()
        with ctx:
            if "fblock" in forms:
                fb = fblock.build_fblocks(hi_round_samples(samples_cat),
                                          mk_fb_geometry(params, parties))
            if "fbstream" in forms:
                if mk_fb_supported(params):  # hi-word 32-bit lines
                    fb_sel = jnp.asarray(fblock.build_sel(
                        hi_round_samples(samples_cat),
                        mk_fb_geometry(params, parties)))
                else:  # exact 64-bit lines (wide-digit sets)
                    fb_sel = jnp.asarray(fblock.build_sel(
                        samples_cat, mk_fb64_geometry(params, parties)))
    ck = MKCloudKey(jnp.asarray(bk) if bk is not None else None,
                    jnp.asarray(ks_mat), parties, params, fb,
                    jnp.asarray(samples_cat) if keep_samples else None,
                    fb_sel)
    if jax.devices()[0].platform != "cpu":
        ck = to_device(ck, device)
    return ck


class _nullctx:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False
