"""Gate bootstrapping: batched blind rotation as a lax.scan of int8 products.

Rework of 3-gen-mk-tfhe/src/bootstrap.jl. The CMux chain over the n LWE key
bits is sequential by construction (each step multiplies the accumulator by
an encrypted monomial power), so latency is bought back with batch: the
whole pipeline is batch-first and every step's external product is one exact
int8 x int8 -> int32 contraction (see ops/poly.py, ops/fblock.py). The
reference's `bara[i] == 0` skip (bootstrap.jl:40-44) is free here:
decompose(0) == 0, so the zero-step contributes an exactly-zero update —
branch-free, same result.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.params import SchemeParams
from ..core.torus import decode_message
from ..lwe import LweKey, LweSample
from ..ops import fblock, poly
from ..rlwe import (RLweKey, RLweSample, mul_by_monomial, rlwe_extract_sample,
                    rlwe_noiseless_trivial)
from ..tgsw import PackedTGsw, TGswSample, pack_tgsw, tgsw_encrypt, tgsw_extern_mul


class BootstrapKey(NamedTuple):
    """n TGSW encryptions of the LWE key bits (bootstrap.jl:1-16), in one or
    both int8 product forms:

    - ``kernels``: int8 limb kernels (ops/poly.pack_kernels_host) driving the
      lax.scan blind rotate ("scan" backend);
    - ``fb``: block-circulant F-block layout (ops/fblock.build_fblocks)
      driving the "fblock" backend — one int8 GEMM per CMux step, the fast
      path;
    - ``samples``: the compact raw TGSW samples (n, l, k+1, k+1, N) torus ints
      (~20 MB at the 128-bit set vs ~3.3 GB for ``fb``) — the serialization
      form (utils/serialize.save_cloud_key); either product form can be
      rebuilt from it on load, the reference's tfhe_io role
      (src/KeyGen.cpp:41-51).
    """

    kernels: Optional[jax.Array] = None  # (n, (k+1)*limbs, l*(k+1), N) int8
    fb: Optional[jax.Array] = None  # (n, D*R*bs, (k+1)*L*bs) int8, seq order
    samples: Optional[jax.Array] = None  # (n, l, k+1, k+1, N) torus


_ROTATE_BACKEND = "auto"  # "auto" | "scan" | "fblock"


def set_rotate_backend(name: str):
    """Select the blind-rotate implementation. "auto" = the F-block scan when
    an F-block key is present, else the limb-kernel scan."""
    global _ROTATE_BACKEND
    assert name in ("auto", "scan", "fblock")
    _ROTATE_BACKEND = name


def get_rotate_backend() -> str:
    return _ROTATE_BACKEND


def _bk_geometry(params: SchemeParams) -> fblock.FBlockGeometry:
    return fblock.fblock_geometry(
        params.lwe_size, params.rlwe_polynomial_degree, params.rlwe_mask_size,
        params.bs_decomp_length, params.rlwe_bits,
        getattr(params, "bk_drop_limbs", 0),
        mask_quantum_bits=getattr(params, "bk_mask_quantum_bits", 0))


def bootstrap_keygen(key, alpha: float, lwe_key: LweKey, rlwe_key: RLweKey,
                     params: SchemeParams, forms=("conv",),
                     fblock_device=None) -> BootstrapKey:
    """TGSW-encrypt each LWE key bit under the RLWE key and pack for the
    int8 products.

    ``forms``: which key layouts to materialise — "conv" (scan backend) and/or
    "fblock" (fblock backend). The F-block build runs on
    ``fblock_device`` (default: the current default device) since the expanded
    key is large (~5.9 GB at the 128-bit set) and should be born where it is
    used.
    """
    drop = getattr(params, "bk_drop_limbs", 0)
    mq = getattr(params, "bk_mask_quantum_bits", 0)
    assert mq == 0, \
        "quantized-mask BKs are insecure (key recovery by rounding + linear " \
        "algebra, tests/test_quantized_mask_attack.py) — removed in r5"
    # BK body compression (sound): the body is rounded to the dropped byte
    # scale at keygen (a deterministic post-hoc degradation of a full-entropy
    # sample — no security impact; extra noise ~2^(8*drop)/sqrt(12) per
    # coefficient at the torus-int scale, ~sigma_bk for one byte). The mask
    # keeps every limb (ops/fblock.default_cols).
    gsw = tgsw_encrypt(key, lwe_key.key, alpha, rlwe_key, params.tgsw,
                       params.rlwe, body_round_bits=8 * drop)
    kernels = None
    fb = None
    if "conv" in forms:
        # full-limb conv kernels: limb drops are an F-block COLUMN concern
        # (body-only); dropping packed mask limbs here would be lossy
        kernels = pack_tgsw(gsw, params.tgsw, 0).kernels
    if "fblock" in forms:
        samples = np.asarray(jax.device_get(gsw.samples))
        geom = _bk_geometry(params)
        ctx = jax.default_device(fblock_device) if fblock_device is not None \
            else _nullcontext()
        with ctx:
            fb = fblock.build_fblocks(samples, geom)
    return BootstrapKey(kernels, fb, gsw.samples)


def rebuild_bk_forms(samples, params: SchemeParams, forms=("conv",),
                     fblock_device=None) -> BootstrapKey:
    """Rebuild the product key form(s) from compact TGSW ``samples`` — the load
    half of serialization (see BootstrapKey.samples)."""
    host = np.asarray(jax.device_get(samples))
    kernels = None
    fb = None
    if "conv" in forms:
        kernels = pack_tgsw(TGswSample(host), params.tgsw, 0).kernels
    if "fblock" in forms:
        geom = _bk_geometry(params)
        ctx = jax.default_device(fblock_device) if fblock_device is not None \
            else _nullcontext()
        with ctx:
            fb = fblock.build_fblocks(host, geom)
    return BootstrapKey(kernels, fb, jnp.asarray(host))


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def _resolve_backend(bk: BootstrapKey) -> str:
    if _ROTATE_BACKEND != "auto":
        return _ROTATE_BACKEND
    return "scan" if bk.fb is None else "fblock"


def mux_rotate(accum: RLweSample, kernels_i, barai, params: SchemeParams) -> RLweSample:
    """accum += BK_i (*) [(X^bara_i - 1) * accum]  (bootstrap.jl:19-23)."""
    rotated = mul_by_monomial(accum, barai)
    temp = RLweSample(rotated.a - accum.a)
    # conv kernels are packed full-limb (bootstrap_keygen/rebuild_bk_forms);
    # the body's rounded low bytes are zero, so no limb_offset here
    gsw = PackedTGsw(kernels_i, params.rlwe_bits, params.rlwe_mask_size, 0)
    delta = tgsw_extern_mul(temp, gsw, params.tgsw)
    return RLweSample(accum.a + delta.a)


def blind_rotate(accum: RLweSample, bk: BootstrapKey, bara, params: SchemeParams) -> RLweSample:
    """Multiply accum by X^{<bara, s>} via the CMux chain (bootstrap.jl:31-45).

    accum.a: (B, k+1, N); bara: (B, n). Dispatches on the configured backend:
    "scan" runs the limb-kernel lax.scan (batch vectorised inside each step);
    "fblock" scans over the block-circulant key (ops/fblock.py) — the same
    bit-exact semantics as one int8 GEMM per step.
    """
    backend = _resolve_backend(bk)

    if backend == "scan":
        assert bk.kernels is not None, "scan backend needs a conv-form BK"
        bara_steps = jnp.swapaxes(bara, 0, 1)  # (n, B)

        def step(acc_a, xs):
            kern_i, bara_i = xs
            acc = RLweSample(acc_a)
            out = mux_rotate(acc, kern_i, bara_i, params)
            return out.a, None

        acc_a, _ = jax.lax.scan(step, accum.a, (bk.kernels, bara_steps))
        return RLweSample(acc_a)

    assert bk.fb is not None, "fblock backend needs an F-block BK"
    tg = params.tgsw
    acc_a = fblock.blind_rotate_fblock(
        accum.a, bk.fb, bara, _bk_geometry(params), tg.decomp_length,
        tg.log2_base, tg.offset)
    return RLweSample(acc_a)


def blind_rotate_and_extract(v, bk: BootstrapKey, barb, bara, params: SchemeParams) -> LweSample:
    """result = LWE(v[phase]) (bootstrap.jl:56-65).

    v: (N,) or (B, N) test polynomial; barb: (B,); bara: (B, n).
    """
    B = bara.shape[0]
    dtype = jnp.int32 if params.rlwe_bits == 32 else jnp.int64
    v = jnp.broadcast_to(jnp.asarray(v, dtype), (B, params.rlwe_polynomial_degree))
    testvect = poly.mul_by_monomial(v, -barb)
    accum = rlwe_noiseless_trivial(testvect, params.rlwe, (B,))
    # noiseless trivial broadcast puts mu at poly index k; shape (B, k+1, N)
    accum = blind_rotate(accum, bk, bara, params)
    return rlwe_extract_sample(accum)


def bootstrap_wo_keyswitch(bk: BootstrapKey, mu, x: LweSample, params: SchemeParams) -> LweSample:
    """Mod-switch to Z_2N then blind-rotate the [mu...mu] test vector
    (bootstrap.jl:75-88). Accepts any leading batch shape (flattened for the
    scan, restored on the output)."""
    N = params.rlwe_polynomial_degree
    lead = x.b.shape
    B = int(np.prod(lead)) if lead else 1
    bara = decode_message(x.a, 2 * N).astype(jnp.int32).reshape(B, -1)
    barb = decode_message(x.b, 2 * N).astype(jnp.int32).reshape(B)
    dtype = jnp.int32 if params.rlwe_bits == 32 else jnp.int64
    testvect = jnp.full((N,), mu, dtype)
    u = blind_rotate_and_extract(testvect, bk, barb, bara, params)
    return LweSample(u.a.reshape(lead + u.a.shape[-1:]), u.b.reshape(lead))


def bootstrap(bk: BootstrapKey, ks, mu, x: LweSample, params: SchemeParams) -> LweSample:
    """Full gate bootstrap: rotate-extract then keyswitch (bootstrap.jl:95-101).

    Eager calls with a static mu route through a jit-cached program (the
    mk/boot3gen pattern): application circuits (apps/knn, circuits/words)
    call gates eagerly, and eager dispatch pays one host round trip per
    op; inside an enclosing jit the impl
    inlines unchanged."""
    if (isinstance(mu, int) and not isinstance(x.b, jax.core.Tracer)
            and not isinstance(x.a, jax.core.Tracer)):
        return _jitted_bootstrap(mu)(bk, ks, x, params)
    return _bootstrap_impl(bk, ks, mu, x, params)


@functools.lru_cache(maxsize=None)
def _jitted_bootstrap(mu_int: int):
    return jax.jit(
        lambda bk, ks, x, params: _bootstrap_impl(bk, ks, mu_int, x, params),
        static_argnums=(3,))


def _bootstrap_impl(bk, ks, mu, x, params):
    from .keyswitch import keyswitch

    u = bootstrap_wo_keyswitch(bk, mu, x, params)
    return keyswitch(ks, params.ks, u)
