"""3rd-gen multikey gate bootstrapping on the shared exact int8 machinery.

Rework of 3-gen-mk-tfhe/src/3gen_mk_internals.jl:59-121 and
mk_keyswitch_3gen (mk_internals.jl:730-744). Because the AKÖ external product
is packed as a standard TGSW kernel (see keys3gen.py), the multikey blind
rotate is ONE lax.scan over parties×n CMux steps — party p's n key bits occupy
steps [p·n, (p+1)·n) exactly like the reference's sequential per-party loop
(mk_blind_rotate_3gen, 3gen_mk_internals.jl:78-84), and the accumulator stays
a single 2-poly RLWE sample regardless of party count (the AKÖ
linear-complexity property).

The multikey keyswitch applies every party's table to the SAME extracted mask,
so all parties share one one-hot digit matrix and the per-party tables
concatenate into a single int8 matmul; the b-parts reduce by summation — the
`psum` target when parties are sharded over the mesh `party` axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..boot.bootstrap import BootstrapKey, blind_rotate_and_extract
from ..core.params import SchemeParams3Gen
from ..core.torus import decode_message, encode_message
from ..lwe import LweSample
from ..ops import poly
from .keys3gen import MKCloudKey
from .samples import MKLweSample


def _eager_jit_dispatch(impl_cache, ck, mu, x):
    """Route an eager gate call through a jit-compiled program (cached per
    static mu): eager dispatch pays one host round trip per op, and
    application circuits (apps/mk_knn) call gates eagerly. Inside an
    enclosing jit (tracer input) the impl inlines as before."""
    if (isinstance(mu, (int, np.integer))
            and not isinstance(x.b, jax.core.Tracer)
            and not isinstance(x.a, jax.core.Tracer)):
        return impl_cache(int(mu))(ck, x)
    return None


def mk_bootstrap_wo_keyswitch(ck: MKCloudKey, mu, x: MKLweSample) -> LweSample:
    out = _eager_jit_dispatch(_jitted_boot_wo_ks, ck, mu, x)
    if out is not None:
        return out
    return _mk_bootstrap_wo_keyswitch_impl(ck, mu, x)


@functools.lru_cache(maxsize=None)
def _jitted_boot_wo_ks(mu_int: int):
    return jax.jit(lambda ck, x: _mk_bootstrap_wo_keyswitch_impl(
        ck, mu_int, x))


def _mk_bootstrap_wo_keyswitch_impl(ck: MKCloudKey, mu, x: MKLweSample) -> LweSample:
    """Mod-switch the (parties, n) mask and blind-rotate the [mu..mu] test
    vector through all parties' CMux steps (3gen_mk_internals.jl:99-109).

    Fast path: when the cloud key carries the hi-word-rounded F-block form
    (keys3gen.mk_fb_supported), the whole 64-bit rotate runs as the 32-bit
    F-block scan over parties*n steps — the extracted sample equals
    t64_to_t32 of the 64-bit accumulator exactly, so the keyswitch below is
    unchanged."""
    params = ck.params
    N = params.rlwe_polynomial_degree
    lead = x.b.shape  # arbitrary leading (batch) shape, () included
    B = int(np.prod(lead)) if lead else 1
    bara = decode_message(x.a, 2 * N).astype(jnp.int32).reshape(B, -1)  # party-major
    barb = decode_message(x.b, 2 * N).astype(jnp.int32).reshape(B)

    from ..boot.bootstrap import get_rotate_backend

    if ((ck.bk_fb is not None or ck.bk_fb_sel is not None)
            and get_rotate_backend() != "scan"):
        u = _fast_rotate_extract(ck, mu, bara, barb, B)
    else:
        dtype = jnp.int32 if params.rlwe_bits == 32 else jnp.int64
        testvect = jnp.full((N,), mu, dtype)
        bk = BootstrapKey(ck.bk_kernels)
        u = blind_rotate_and_extract(testvect, bk, barb, bara, params)
    return LweSample(u.a.reshape(lead + u.a.shape[-1:]), u.b.reshape(lead))


def _fast_rotate_extract(ck: MKCloudKey, mu, bara, barb, B: int) -> LweSample:
    """Fast blind rotate over the F-block key + extract: the 32-bit hi-word
    path (rounded key) for byte-digit sets, or the exact 64-bit streamed path
    for wide-digit sets (Bg > 2^8, where hi-word rounding noise is amplified
    by the digit magnitude). Pre-expanded keys scan directly; compact keys
    expand per step chunk."""
    from ..core.params import TGswParams
    from ..ops import fblock
    from ..rlwe import RLweSample, rlwe_extract_sample
    from .keys3gen import mk_fb64_geometry, mk_fb_geometry, mk_fb_supported

    params = ck.params
    if ck.bk_fb_sel is not None and not mk_fb_supported(params):
        # exact 64-bit streamed rotate (wide-digit sets; no rounding at all)
        assert jax.config.jax_enable_x64, \
            "the wide-digit 64-bit streamed path needs jax_enable_x64"
        geom = mk_fb64_geometry(params, ck.parties)
        tg = TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 64)
        mu_t = jnp.asarray(mu, jnp.int64)
    else:
        geom = mk_fb_geometry(params, ck.parties)
        tg = TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 32)
        # mu is a multiple of 2^32 (l*log2B <= 31): its hi word is exact. A
        # 32-bit-magnitude value IS the hi word already (the x64-off path and
        # encode_message(s, m, int32) == encode_message(s, m, int64) >> 32).
        if isinstance(mu, (int, np.integer)):
            mu = int(mu)
            mu_t = jnp.int32(mu >> 32 if abs(mu) >= (1 << 31) else mu)
        else:
            mu_a = jnp.asarray(mu)
            mu_t = (mu_a if mu_a.dtype == jnp.int32
                    else (mu_a >> 32).astype(jnp.int32))
    tv = poly.mul_by_monomial(jnp.broadcast_to(mu_t, (B, geom.N)), -barb)
    acc0 = jnp.zeros((B, geom.C, geom.N), mu_t.dtype).at[:, geom.C - 1].set(tv)
    args = (geom, tg.decomp_length, tg.log2_base, tg.offset)
    if ck.bk_fb is not None:
        acc = fblock.blind_rotate_fblock(acc0, ck.bk_fb, bara, *args)
    else:
        acc = fblock.blind_rotate_streamed(acc0, ck.bk_fb_sel, bara, *args)
    return rlwe_extract_sample(RLweSample(acc))


def mk_keyswitch(ck: MKCloudKey, u: LweSample) -> MKLweSample:
    if not isinstance(u.b, jax.core.Tracer) and not isinstance(
            u.a, jax.core.Tracer):
        return _jitted_keyswitch()(ck, u)
    return _mk_keyswitch_impl(ck, u)


@functools.lru_cache(maxsize=None)
def _jitted_keyswitch():
    return jax.jit(_mk_keyswitch_impl)


def _mk_keyswitch_impl(ck: MKCloudKey, u: LweSample) -> MKLweSample:
    """Per-party keyswitch of the extracted sample with one shared one-hot
    matmul (mk_keyswitch_3gen, mk_internals.jl:730-744)."""
    params = ck.params
    ksp = params.ks
    l, lb = ksp.decomp_length, ksp.log2_base
    base = 1 << lb
    n = params.lwe_size
    P = ck.parties

    lead = u.b.shape
    prec_offset = jnp.int32(1 << (32 - (1 + lb * l)))
    aibar = u.a + prec_offset  # (..., N_in)

    j = np.arange(1, l + 1, dtype=np.int32)
    digits = (aibar[..., None] >> (32 - j * lb)) & (base - 1)  # (..., N_in, l)
    h = np.arange(1, base, dtype=np.int32)
    onehot = (digits[..., None] == h).astype(jnp.int8)
    onehot = onehot.reshape(lead + (-1,))

    deltas = jnp.dot(onehot, ck.ks_mat, preferred_element_type=jnp.int32)
    deltas = deltas.reshape(lead + (P, n + 1, 4))
    deltas = poly.limb_combine(deltas, 32, axis=-1)  # (..., P, n+1)

    a = -deltas[..., :n]  # (..., P, n)
    b = u.b - jnp.sum(deltas[..., n], axis=-1, dtype=jnp.int32)
    return MKLweSample(a, b)


def mk_bootstrap(ck: MKCloudKey, mu, x: MKLweSample) -> MKLweSample:
    """Full multikey bootstrap (mk_bootstrap_3gen, 3gen_mk_internals.jl:112-117)."""
    out = _eager_jit_dispatch(_jitted_bootstrap, ck, mu, x)
    if out is not None:
        return out
    u = _mk_bootstrap_wo_keyswitch_impl(ck, mu, x)
    return mk_keyswitch(ck, u)


@functools.lru_cache(maxsize=None)
def _jitted_bootstrap(mu_int: int):
    return jax.jit(lambda ck, x: mk_keyswitch(
        ck, _mk_bootstrap_wo_keyswitch_impl(ck, mu_int, x)))
