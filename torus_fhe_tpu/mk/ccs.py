"""1st-gen (CCS, Chen–Chillotti–Song) multikey TFHE.

Rework of the reference CCS scheme (3-gen-mk-tfhe/src/mk_internals.jl):
shared key + per-party public keys (mk_internals.jl:162-300), uni-encryption
`mk_tgsw_encrypt` (:390-446), the hybrid product `UniProduct_old` (:477-536),
the party-sequential blind rotate (:805-852) and per-party keyswitch
(:712-726).

Design notes:
  * The CCS accumulator is a (parties+1)-poly MKRLWE sample whose mask grows
    with the party count (unlike AKÖ). It is batched as one (B, P+1, N) array.
  * Every polynomial product in `UniProduct_old` is an exact int8-limb
    contraction (ops/poly.py) of gadget digits against pre-packed kernels —
    where the reference runs f64 FFTs and reasons about the 54-bit budget
    (mk_internals.jl:674-681), this path has *zero* rounding noise.
  * The per-(party, key-bit) kernels (d1/f0/f1 of each uni-encryption) ride a
    single lax.scan over parties*n CMux steps, mirroring the reference's
    sequential loops; per-party constants (public keys, shared key) are closed
    over. Batch is the throughput axis.
  * Keygen is host-side exact (ops/hostmath) and ships packed int8 tensors to
    the device once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_dataclass

from ..boot.keyswitch import keyswitch_keygen
from ..core import rng as trng
from ..core.params import SchemeParamsCCS, TGswParams
from ..core.torus import decode_message, encode_message, t64_to_t32
from ..lwe import LweKey, lwe_keygen
from ..ops import hostmath, poly
from ..rlwe import RLweKey, extract_lwe_key, rlwe_keygen
from ..utils.device import on_host, to_device
from .samples import MKLweSample, mk_lwe_noiseless_trivial


# ---------------------------------------------------------------------------
# Key material
# ---------------------------------------------------------------------------


class CCSSecretKey(NamedTuple):
    """One party's secret material (SecretKey + RLweKey per CloudKeyPart,
    mk_api.jl:368-394)."""

    lwe: LweKey
    rlwe: RLweKey


def ccs_party_keygen(key, params: SchemeParamsCCS) -> CCSSecretKey:
    k1, k2 = jax.random.split(key)
    with on_host():
        lwe = lwe_keygen(k1, params.lwe)
        rlwe = rlwe_keygen(k2, params.rlwe, negative=False)  # binary RLWE key
    return CCSSecretKey(lwe, rlwe)


def gen_shared_key(key, params: SchemeParamsCCS) -> jax.Array:
    """Common random polynomials a[i], i=1..l (SharedKey,
    mk_internals.jl:162-174)."""
    dtype = jnp.int32 if params.rlwe_bits == 32 else jnp.int64
    l, N = params.bs_decomp_length, params.rlwe_polynomial_degree
    return trng.uniform_torus(key, (l, N), dtype)


def ccs_public_keygen(key, rlwe_key: RLweKey, shared_a,
                      params: SchemeParamsCCS) -> jax.Array:
    """b_p[i] = s_p ⊛ a[i] + e (PublicKey, mk_internals.jl:220-261)."""
    a = np.asarray(jax.device_get(shared_a))
    s = np.asarray(jax.device_get(rlwe_key.key[0]))
    prod = hostmath.negacyclic_polymul_host(s, a, params.rlwe_bits)
    dtype = jnp.int32 if params.rlwe_bits == 32 else jnp.int64
    noise = trng.gaussian_torus(key, 0, params.bs_noise_stddev, a.shape, dtype)
    return jnp.asarray(prod) + noise


def uni_encrypt_bits(key, messages, alpha: float, rlwe_key: RLweKey,
                     shared_a: np.ndarray, pub_b: np.ndarray,
                     gp: TGswParams, N: int):
    """CCS uni-encryption of M integer messages (RGSW.UniEnc,
    mk_tgsw_encrypt, mk_internals.jl:390-446), vectorised over messages.

    Returns the three components the blind rotate consumes — d1 (encrypts
    m·g under the shared randomness r), f0/f1 (encrypt r·g under the party
    key) — as raw torus arrays of shape (M, l, N). c0/c1/d0 of the full
    UniEnc tuple are not used by `UniProduct_old` (the reference transforms
    only d1, f0, f1: mk_internals.jl:466-474) and are not materialised.
    """
    bits = gp.bits
    npdt = np.int32 if bits == 32 else np.int64
    M = int(np.shape(messages)[0])
    l = gp.decomp_length
    k1, k2, k3 = jax.random.split(key, 3)

    r = np.asarray(jax.device_get(trng.uniform_binary(k1, (M, 1, N))), np.int32)
    dtype = jnp.int32 if bits == 32 else jnp.int64
    errs = np.asarray(jax.device_get(trng.gaussian_torus(
        k2, 0, alpha, (2, M, l, N), dtype)), npdt)
    f1 = np.asarray(jax.device_get(trng.uniform_torus(k3, (M, l, N), dtype)), npdt)

    gadget = np.asarray(gp.gadget_values, npdt)  # (l,)
    msg = np.asarray(messages, npdt)

    # d1 = r ⊛ a + e + m·g
    d1 = hostmath.negacyclic_polymul_host(r, shared_a[None], bits) + errs[0]
    d1[..., 0] += msg[:, None] * gadget
    # f0 = s ⊛ f1 + e + r·g (r is a binary polynomial: poly · gadget scalar)
    s = np.asarray(jax.device_get(rlwe_key.key[0]))
    f0 = hostmath.negacyclic_polymul_host(s, f1, bits) + errs[1]
    f0 = (f0.astype(np.int64)
          + r.astype(np.int64) * gadget.astype(np.int64)[None, :, None]
          ).astype(npdt)
    return d1, f0, f1


def _pack_l_to_1(polys: np.ndarray, bits: int) -> np.ndarray:
    """Pack (..., l, N) torus kernels contracting l digit rows -> 1 output
    poly: returns (..., limbs, l, N) int8 (poly.pack_kernels_host layout)."""
    return poly.pack_kernels_host(polys[..., None, :], bits)


@dataclass
class CCSCloudKey:
    """Assembled CCS cloud key (MKCloudKey, mk_api.jl:440-459): packed
    uni-encryption kernels over parties*n CMux steps, per-party public-key
    kernels, shared-key kernel, and stacked keyswitch tables.

    The ``*_sel`` / ``*_fb`` fields are the F-block fast backend (VERDICT r3
    item 4 — backend parity with AKÖ): the per-step d1/f0/f1 kernels as
    compact limb lines expanded per step chunk at rotate time
    (ops/fblock.expand_fblock_chunk), the per-party pk and shared-key
    kernels pre-expanded (they are tiny and step-invariant). CCS runs a
    32-bit torus, so no hi-word rounding is involved — the fast path is
    bit-identical to the conv scan."""

    d_kern: jax.Array   # (P*n, L, l, N) int8 — d1 of each (party, key bit)
    f0_kern: jax.Array  # (P*n, L, l, N) int8
    f1_kern: jax.Array  # (P*n, L, l, N) int8
    pk_kern: jax.Array  # (P, L, l, N) int8 — party public keys b_p
    sk_kern: jax.Array  # (L, l, N) int8 — shared key a
    ks_mats: jax.Array  # (P, K, (n+1)*4) int8 — per-party keyswitch tables
    parties: int = 1
    params: SchemeParamsCCS = None
    d_sel: jax.Array = None   # (P*n, l, 2N, limbs) int8 compact F-block lines
    f0_sel: jax.Array = None
    f1_sel: jax.Array = None
    pk_fb: jax.Array = None   # (P, D*l*bs, limbs*bs) int8 expanded
    sk_fb: jax.Array = None   # (D*l*bs, limbs*bs) int8 expanded


register_dataclass(CCSCloudKey,
                   data_fields=("d_kern", "f0_kern", "f1_kern", "pk_kern",
                                "sk_kern", "ks_mats", "d_sel", "f0_sel",
                                "f1_sel", "pk_fb", "sk_fb"),
                   meta_fields=("parties", "params"))


def ccs_fb_geometry(params: SchemeParamsCCS, parties: int):
    """F-block geometry of ONE gadget contraction line (C=1 output poly,
    l digit rows) over the parties*n CMux steps."""
    from ..ops import fblock

    return fblock.fblock_geometry(
        parties * params.lwe_size, params.rlwe_polynomial_degree, 0,
        params.bs_decomp_length, params.rlwe_bits, 0)


def ccs_cloud_keygen(key, secret_keys: Sequence[CCSSecretKey],
                     params: SchemeParamsCCS, device=None,
                     forms=("conv",)) -> CCSCloudKey:
    """Full CCS cloud-key pipeline (SharedKey → PublicKeys → per-party
    BootstrapKeyPart uni-encryptions → MKBootstrapKey + KSKs;
    mk_internals.jl:752-802, mk_api.jl:368-474).

    ``forms``: "conv" packs the scan-backend kernels; "fb" builds the F-block
    fast backend (compact per-step lines + pre-expanded pk/sk blocks)."""
    from ..ops import fblock

    parties = len(secret_keys)
    assert parties <= params.max_parties
    gp = params.tgsw
    bits = params.rlwe_bits
    N = params.rlwe_polynomial_degree
    l = gp.decomp_length
    geom = ccs_fb_geometry(params, parties)

    def _sel(polys):
        # (M, l, N) torus -> compact F-block lines (M, l, 2N, limbs) int8
        return fblock.build_sel(
            np.asarray(polys).reshape(-1, l, 1, 1, N), geom)

    with on_host():
        ks_key, kp, kb, kk = jax.random.split(key, 4)
        shared_a = np.asarray(jax.device_get(gen_shared_key(ks_key, params)))
        pubs = [np.asarray(jax.device_get(ccs_public_keygen(
            jax.random.fold_in(kp, p), sk.rlwe, shared_a, params)))
            for p, sk in enumerate(secret_keys)]

        d_k, f0_k, f1_k = [], [], []
        d_s, f0_s, f1_s = [], [], []
        for p, sk in enumerate(secret_keys):
            bits_msg = np.asarray(jax.device_get(sk.lwe.key), np.int64)
            d1, f0, f1 = uni_encrypt_bits(
                jax.random.fold_in(kb, p), bits_msg, params.bs_noise_stddev,
                sk.rlwe, shared_a, pubs[p], gp, N)
            if "conv" in forms:
                d_k.append(_pack_l_to_1(d1, bits))
                f0_k.append(_pack_l_to_1(f0, bits))
                f1_k.append(_pack_l_to_1(f1, bits))
            if "fb" in forms:
                d_s.append(_sel(d1))
                f0_s.append(_sel(f0))
                f1_s.append(_sel(f1))

        pk_kern = _pack_l_to_1(np.stack(pubs), bits)  # (P, L, l, N)
        sk_kern = _pack_l_to_1(shared_a, bits)  # (L, l, N)

        mats = []
        for p, sk in enumerate(secret_keys):
            ks = keyswitch_keygen(jax.random.fold_in(kk, p),
                                  params.ks_noise_stddev, params.ks,
                                  sk.lwe, extract_lwe_key(sk.rlwe))
            mats.append(np.asarray(jax.device_get(ks.mat)))

    d_sel = f0_sel = f1_sel = pk_fb = sk_fb = None
    if "fb" in forms:
        d_sel = jnp.asarray(np.concatenate(d_s))
        f0_sel = jnp.asarray(np.concatenate(f0_s))
        f1_sel = jnp.asarray(np.concatenate(f1_s))
        pk_fb = jnp.stack([fblock.expand_fblock_chunk(
            jnp.asarray(_sel(pubs[p][None])), geom)[0] for p in range(parties)])
        sk_fb = fblock.expand_fblock_chunk(
            jnp.asarray(_sel(shared_a[None])), geom)[0]
    ck = CCSCloudKey(jnp.asarray(np.concatenate(d_k)) if d_k else None,
                     jnp.asarray(np.concatenate(f0_k)) if f0_k else None,
                     jnp.asarray(np.concatenate(f1_k)) if f1_k else None,
                     jnp.asarray(pk_kern), jnp.asarray(sk_kern),
                     jnp.asarray(np.stack(mats)), parties, params,
                     d_sel, f0_sel, f1_sel, pk_fb, sk_fb)
    if jax.devices()[0].platform != "cpu":
        ck = to_device(ck, device)
    return ck


# ---------------------------------------------------------------------------
# The hybrid product and blind rotate
# ---------------------------------------------------------------------------


def _gadget_contract(x, kern, gp: TGswParams):
    """sum_l g(x)_l ⊛ kern_l for each input poly: x (..., N) torus, kern
    (L, l, N) packed int8 → (..., N) torus. The exact int8 form of the
    reference's decompose → FFT → pointwise-sum → iFFT chains
    (UniProduct_old, mk_internals.jl:486-529)."""
    lead = x.shape[:-1]
    N = x.shape[-1]
    digits = poly.decompose(x, gp.decomp_length, gp.log2_base, gp.bits,
                            gp.offset)  # (..., l, N)
    blocks = poly.digits_to_i8_rows(digits, gp.log2_base)
    total = None
    for m, blk in enumerate(blocks):
        rows = blk.reshape((-1,) + blk.shape[-2:])  # (B', l, N)
        prod = poly.negacyclic_extern_product(rows, kern, gp.bits, 1)
        prod = prod.reshape(lead + (N,))
        if m:
            prod = prod << (8 * m)
        total = prod if total is None else total + prod
    return total


def uni_product(x, d_k, f0_k, f1_k, pk_kern, sk_kern, onehot,
                gp: TGswParams):
    """UniProduct (mk_internals.jl:477-536) on a batched (B, P+1, N)
    accumulator delta ``x``:

        u_i  = <g(x_i), d1>            (all P masks + body)
        v_i  = <g(x_i), b_i>           (per-party public keys)
        v_0  = -<g(x_body), a>         (shared key)
        w0/w1 = <g(v_j), f0/f1>        summed over all j
        out  = u;  out[party] += Σw1;  out[body] += Σw0

    ``onehot``: (P,) selector of the owning party (traced, scanned over).
    """
    P = x.shape[1] - 1
    u = _gadget_contract(x, d_k, gp)  # (B, P+1, N)
    v_par = jnp.stack(
        [_gadget_contract(x[:, p], pk_kern[p], gp) for p in range(P)], axis=1)
    v0 = -_gadget_contract(x[:, P], sk_kern, gp)  # (B, N)
    v = jnp.concatenate([v_par, v0[:, None]], axis=1)  # (B, P+1, N)
    w0 = _gadget_contract(v, f0_k, gp).sum(axis=1, dtype=u.dtype)  # (B, N)
    w1 = _gadget_contract(v, f1_k, gp).sum(axis=1, dtype=u.dtype)
    delta_a = u[:, :P] + onehot[None, :, None].astype(u.dtype) * w1[:, None, :]
    delta_b = u[:, P] + w0
    return jnp.concatenate([delta_a, delta_b[:, None]], axis=1)


def ccs_blind_rotate(acc, ck: CCSCloudKey, bara):
    """Party-sequential CMux chain as one lax.scan over parties*n steps
    (mk_blind_rotate + mk_mux_rotate, mk_internals.jl:805-828):
    ACC += UniProduct((X^bara − 1)·ACC, UniEnc_{party,bit}).

    acc: (B, P+1, N); bara: (B, P*n) party-major.
    """
    params = ck.params
    gp = params.tgsw
    P, n = ck.parties, params.lwe_size
    onehots = jnp.asarray(np.repeat(np.eye(P, dtype=np.int32), n, axis=0))
    bara_steps = jnp.swapaxes(bara, 0, 1)  # (P*n, B)

    def step(acc, xs):
        d_k, f0_k, f1_k, onehot, bara_i = xs
        rotated = poly.mul_by_monomial(acc, bara_i)
        delta = uni_product(rotated - acc, d_k, f0_k, f1_k,
                            ck.pk_kern, ck.sk_kern, onehot, gp)
        return acc + delta, None

    acc, _ = jax.lax.scan(
        step, acc, (ck.d_kern, ck.f0_kern, ck.f1_kern, onehots, bara_steps))
    return acc


def _fb_contract_polys(x, fstep, geom, gp: TGswParams):
    """sum_l g(x_i)_l ⊛ K_l for each input poly via the F-block matmul:
    x (B, K, N) torus32, fstep (D*l*bs, limbs*bs) int8 → (B, K, N)."""
    from ..ops import fblock

    B, K, N = x.shape
    out = fblock.apply_fblock(x.reshape(B * K, 1, N), fstep, geom,
                              gp.decomp_length, gp.log2_base, gp.offset)
    return out.reshape(B, K, N)


def _ccs_stream_chunk() -> int:
    """Step-chunk size for the F-block CMux chain. The deeper >=8-party
    gadgets (l=5 at 8p, l=12 at 16p) multiply the per-chunk expanded-key
    volume; TORUS_CCS_STREAM_CHUNK lets the perf harness shrink the chunk
    when the fused chunk body trips device limits (kms._stream_chunk
    pattern)."""
    import os

    return int(os.environ.get("TORUS_CCS_STREAM_CHUNK", "32"))


def ccs_blind_rotate_fb(acc, ck: CCSCloudKey, bara, chunk: int | None = None):
    """The CCS CMux chain on the F-block backend: per step-chunk, the compact
    d1/f0/f1 lines expand on device (ops/fblock.expand_fblock_chunk) and every
    gadget contraction of UniProduct_old (mk_internals.jl:477-536) runs as
    block-circulant int8 matmuls — same math as ccs_blind_rotate,
    bit-identical output, none of the conv lowering.
    """
    from ..ops import fblock

    if chunk is None:
        chunk = _ccs_stream_chunk()
    params = ck.params
    gp = params.tgsw
    geom = ccs_fb_geometry(params, ck.parties)
    P, n = ck.parties, params.lwe_size
    steps = P * n
    B = acc.shape[0]
    onehots = jnp.asarray(np.repeat(np.eye(P, dtype=np.int32), n, axis=0))
    spad = (-steps) % chunk
    bara = jnp.asarray(bara)
    if spad:  # identity pad steps: bara=0 digits x zero kernels
        z = lambda a: jnp.concatenate(
            [a, jnp.zeros((spad,) + a.shape[1:], a.dtype)], axis=0)
        d_sel, f0_sel, f1_sel = z(ck.d_sel), z(ck.f0_sel), z(ck.f1_sel)
        onehots = z(onehots)
        bara = jnp.concatenate(
            [bara, jnp.zeros((B, spad), bara.dtype)], axis=1)
    else:
        d_sel, f0_sel, f1_sel = ck.d_sel, ck.f0_sel, ck.f1_sel

    def step(acc, xs):
        d_f, f0_f, f1_f, onehot, bara_i = xs
        rotated = poly.mul_by_monomial(acc, bara_i)
        x = rotated - acc  # (B, P+1, N)
        u = _fb_contract_polys(x, d_f, geom, gp)
        v_par = jnp.stack(
            [_fb_contract_polys(x[:, p:p + 1], ck.pk_fb[p], geom, gp)[:, 0]
             for p in range(P)], axis=1)
        v0 = -_fb_contract_polys(x[:, P:P + 1], ck.sk_fb, geom, gp)[:, 0]
        v = jnp.concatenate([v_par, v0[:, None]], axis=1)
        w0 = _fb_contract_polys(v, f0_f, geom, gp).sum(axis=1, dtype=u.dtype)
        w1 = _fb_contract_polys(v, f1_f, geom, gp).sum(axis=1, dtype=u.dtype)
        delta_a = (u[:, :P]
                   + onehot[None, :, None].astype(u.dtype) * w1[:, None, :])
        delta_b = u[:, P] + w0
        return acc + jnp.concatenate([delta_a, delta_b[:, None]], axis=1), None

    # outer scan over chunks (the body compiles ONCE); inner scan over the
    # chunk's steps with the three per-step kernels expanded on entry
    n_chunks = (steps + spad) // chunk
    d_c = d_sel.reshape((n_chunks, chunk) + d_sel.shape[1:])
    f0_c = f0_sel.reshape((n_chunks, chunk) + f0_sel.shape[1:])
    f1_c = f1_sel.reshape((n_chunks, chunk) + f1_sel.shape[1:])
    oh_c = onehots.reshape((n_chunks, chunk) + onehots.shape[1:])
    bara_c = jnp.swapaxes(bara.reshape(B, n_chunks, chunk), 0, 1)

    def chunk_body(acc, xs):
        d_k, f0_k, f1_k, oh_k, bara_k = xs
        inner = (fblock.expand_fblock_chunk(d_k, geom),
                 fblock.expand_fblock_chunk(f0_k, geom),
                 fblock.expand_fblock_chunk(f1_k, geom),
                 oh_k, jnp.swapaxes(bara_k, 0, 1))
        acc, _ = jax.lax.scan(step, acc, inner)
        return acc, None

    acc, _ = jax.lax.scan(chunk_body, acc,
                          (d_c, f0_c, f1_c, oh_c, bara_c))
    return acc


def mk_rlwe_extract_sample(acc) -> MKLweSample:
    """Constant-coefficient extraction per party mask
    (mk_rlwe_extract_sample{,_64}, mk_internals.jl:149-156,
    new_mk_internals.jl:294-299). acc: (B, P+1, N) → a (B, P, N), b (B,)."""
    P = acc.shape[1] - 1
    mask = acc[:, :P]
    rev = jnp.concatenate([mask[..., :1], -mask[..., :0:-1]], axis=-1)
    b = acc[:, P, 0]
    if acc.dtype == jnp.int64:
        return MKLweSample(t64_to_t32(rev), t64_to_t32(b))
    return MKLweSample(rev, b)


def mk_keyswitch(ck_ks_mats, ks_params, n_out: int, u: MKLweSample) -> MKLweSample:
    """Per-party keyswitch: party p's table applied to party p's extracted
    mask, b-parts summed (mk_keyswitch, mk_internals.jl:712-726). One einsum
    over (party, one-hot digit) is one int8 matmul."""
    l, lb = ks_params.decomp_length, ks_params.log2_base
    base = 1 << lb
    lead = u.b.shape

    prec_offset = jnp.int32(1 << (32 - (1 + lb * l)))
    aibar = u.a + prec_offset  # (..., P, N_in)
    j = np.arange(1, l + 1, dtype=np.int32)
    digits = (aibar[..., None] >> (32 - j * lb)) & (base - 1)
    h = np.arange(1, base, dtype=np.int32)
    onehot = (digits[..., None] == h).astype(jnp.int8)
    P = u.a.shape[-2]
    onehot = onehot.reshape(lead + (P, -1))  # (..., P, K)

    deltas = jnp.einsum("...pk,pkc->...pc", onehot, ck_ks_mats,
                        preferred_element_type=jnp.int32)
    deltas = deltas.reshape(lead + (P, n_out + 1, 4))
    deltas = poly.limb_combine(deltas, 32, axis=-1)  # (..., P, n_out+1)

    a = -deltas[..., :n_out]
    b = u.b - jnp.sum(deltas[..., n_out], axis=-1, dtype=jnp.int32)
    return MKLweSample(a, b)


# ---------------------------------------------------------------------------
# Bootstrap + gates
# ---------------------------------------------------------------------------


def mk_bootstrap_wo_keyswitch(ck: CCSCloudKey, mu, x: MKLweSample) -> MKLweSample:
    """Mod-switch + blind rotate of the [mu..mu] test vector
    (mk_bootstrap_wo_keyswitch, mk_internals.jl:841-852)."""
    params = ck.params
    N = params.rlwe_polynomial_degree
    P = ck.parties
    lead = x.b.shape
    B = int(np.prod(lead)) if lead else 1
    bara = decode_message(x.a, 2 * N).astype(jnp.int32).reshape(B, -1)
    barb = decode_message(x.b, 2 * N).astype(jnp.int32).reshape(B)
    dtype = jnp.int32 if params.rlwe_bits == 32 else jnp.int64
    testvect = jnp.full((N,), mu, dtype)
    body = poly.mul_by_monomial(jnp.broadcast_to(testvect, (B, N)), -barb)
    acc = jnp.concatenate([jnp.zeros((B, P, N), dtype), body[:, None]], axis=1)
    if ck.d_sel is not None:
        acc = ccs_blind_rotate_fb(acc, ck, bara)
    else:
        acc = ccs_blind_rotate(acc, ck, bara)
    u = mk_rlwe_extract_sample(acc)
    return MKLweSample(u.a.reshape(lead + u.a.shape[-2:]), u.b.reshape(lead))


def mk_bootstrap(ck: CCSCloudKey, mu, x: MKLweSample) -> MKLweSample:
    """Full CCS multikey bootstrap (mk_bootstrap, mk_internals.jl:855-858)."""
    u = mk_bootstrap_wo_keyswitch(ck, mu, x)
    return mk_keyswitch(ck.ks_mats, ck.params.ks, ck.params.lwe_size, u)


def mk_gate_nand(ck: CCSCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    """CCS multikey NAND (mk_gate_nand, mk_gates.jl:7-13)."""
    mu = encode_message(1, 8)
    temp = mk_lwe_noiseless_trivial(mu, ck.params.lwe, ck.parties, x.b.shape) - x - y
    return mk_bootstrap(ck, mu, temp)
