"""Negacyclic polynomial arithmetic — the hot products of TFHE.

The reference multiplies negacyclic polynomials with a twisted half-size
complex f64 FFT (3-gen-mk-tfhe/src/polynomials.jl:81-247) / spqlios AVX FFT
(C++ side), relying on the 53-bit f64 mantissa for exactness. This module
takes a route that is *exact* and runs on int8 matrix hardware:

    negacyclic convolution == int8 x int8 -> int32 matmul/conv,
    with torus operands split into balanced signed byte limbs.

A gadget-decomposed digit fits in int8 whenever log2_base <= 8 (all shipped
parameter sets except the 3gen 16-party B=2^26 set, which is handled by
splitting digits into byte limbs too). A Torus32 kernel splits into 4 byte
limbs, Torus64 into 8. Every partial product |d| * |k_limb| * N * R stays
below 2^31, so int32 accumulation is exact, and the limb recombination
wraps mod 2^bits in two's complement — matching the reference's `_wo_FFT`
exact-arithmetic twin implementations (tgsw.jl:152-156) bit for bit, with
*zero* FFT rounding noise.

Two interchangeable backends compute the batched convolution:
  * "conv"   — lax.conv_general_dilated,
  * "matmul" — explicit negacyclic circulant built by gather + jnp.dot.
XLA:GPU refuses integer convolutions with an int32 result (cuDNN's integer
convolutions give s8 or f32), so GPUs get "matmul"; other platforms get
"conv" (`resolve_backend`).
plus an int64 schoolbook oracle (`negacyclic_polymul_ref`) mirroring
nonFFTmul2 (src/threshold_decryption_functions.cpp:377-397) for parity tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# ---------------------------------------------------------------------------
# Limb splitting
# ---------------------------------------------------------------------------


def n_limbs_for(bits: int) -> int:
    return (bits + 7) // 8


def limb_split_signed_host(x: np.ndarray, bits: int) -> np.ndarray:
    """Split integers into balanced signed byte limbs, host-side (numpy).

    x == sum_m limbs[..., m] * 256**m  (mod 2**bits), each limb in [-128, 127].
    Appends the limb axis last.
    """
    nl = n_limbs_for(bits)
    # work on the unsigned residue; uint64 arithmetic wraps mod 2^64
    v = np.asarray(x).astype(np.int64).astype(np.uint64)
    if bits < 64:
        v &= np.uint64((1 << bits) - 1)
    limbs = np.empty(np.shape(x) + (nl,), dtype=np.int8)
    for m in range(nl):
        l = ((v + np.uint64(128)) & np.uint64(255)).astype(np.int64) - 128
        limbs[..., m] = l.astype(np.int8)
        v = (v - l.astype(np.uint64)) >> np.uint64(8)
    return limbs


def limb_split_signed(x, bits: int):
    """In-graph balanced signed byte-limb split (for traced values).

    Works on the unsigned residue held in the same-width unsigned dtype so the
    subtraction cannot overflow.
    """
    nl = n_limbs_for(bits)
    udtype = jnp.uint32 if bits <= 32 else jnp.uint64
    v = jax.lax.bitcast_convert_type(jnp.asarray(x), udtype) if jnp.asarray(x).dtype.kind == "i" else jnp.asarray(x, udtype)
    limbs = []
    for _ in range(nl):
        l = ((v + 128) & 255).astype(jnp.int32) - 128  # in [-128, 127]
        limbs.append(l.astype(jnp.int8))
        v = (v - l.astype(udtype)) >> 8  # modular subtract keeps the residue exact
    return jnp.stack(limbs, axis=-1)


def limb_combine(parts, bits: int, axis: int = -1):
    """Inverse of limb splitting for int32 partial results -> torus dtype.

    parts: int32 array with a limb axis; returns sum(parts << 8m) mod 2^bits.
    """
    dtype = jnp.int32 if bits <= 32 else jnp.int64
    parts = jnp.moveaxis(parts, axis, -1)
    out = jnp.zeros(parts.shape[:-1], dtype)
    for m in range(parts.shape[-1]):
        out = out + (parts[..., m].astype(dtype) << (8 * m))
    return out


# ---------------------------------------------------------------------------
# Exact schoolbook oracle
# ---------------------------------------------------------------------------


def negacyclic_polymul_ref(a, b):
    """Exact negacyclic product of int polys a (..., N) and torus polys b (..., N).

    Circulant formulation of the reference's schoolbook nonFFTmul2
    (src/threshold_decryption_functions.cpp:377-397) without its final odd
    prime reduction: results wrap mod 2^bits of b's dtype. Materialises an
    (..., N, N) int64 circulant — use only for small N (tests/oracles);
    keygen-scale exact products live in ops/hostmath.py.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    N = a.shape[-1]
    out_dtype = b.dtype
    a64 = a.astype(jnp.int64)
    bext = jnp.concatenate([b, -b], axis=-1).astype(jnp.int64)  # int64 negation wraps ok
    idx = (np.arange(N)[None, :] - np.arange(N)[:, None]) % (2 * N)  # (r, c)
    circ = bext[..., idx]  # (..., N, N)
    res = jnp.einsum("...r,...rc->...c", a64, circ)
    return res.astype(out_dtype)


# ---------------------------------------------------------------------------
# Limb-split f32 FFT product (device-friendly, bounded error, any N)
# ---------------------------------------------------------------------------


def negacyclic_polymul_fft64(a, b, bits: int = 32):
    """Negacyclic product of int polys a (..., N) with torus polys b (..., N)
    via 16-bit-limb complex128 FFTs — O(N log N) host math that scales to the
    reference's huge-ring sweeps (N = 2^20+, src/TlweTwoTwo.cpp:53-55).

    Semantics match the reference's production partial-decrypt path, which is
    itself an approximate f64 FFT (`torusPolynomialAddMulR`, spqlios; used by
    src/threshold_decryption_functions.cpp:462). With 16-bit limbs the f64
    rounding error stays < 2^-20 of the torus even at N = 2^20 — far below
    every smudging bound the callers add on top. Runs in numpy on the host
    (the threshold partial-decrypt is client-side work in the reference's
    cloud/client split). Use the exact conv/matmul
    backends or negacyclic_polymul_ref where bit-exactness matters.

    Torus wrap-around (mod 2^bits) kills every limb cross-product with scale
    >= 2^bits, so only 3 of the 4 products survive and the two 2^16-scale
    terms share one inverse FFT.
    """
    assert bits == 32, "fft polymul implements the 32-bit torus"
    a = np.asarray(jax.device_get(a)).astype(np.int64)
    b = np.asarray(jax.device_get(b)).astype(np.int64)
    N = a.shape[-1]
    k = np.arange(N)
    tw = np.exp(-1j * np.pi * k / N)
    itw = np.exp(1j * np.pi * k / N)

    def split16(x):
        # lo ≡ x (mod 2^16), centred in [-2^15, 2^15) so x - lo is an exact
        # multiple of 2^16 and both limbs stay small for the f64 FFT
        lo = ((x + (1 << 15)) & 0xFFFF) - (1 << 15)
        hi = (x - lo) >> 16
        return lo.astype(np.float64), hi.astype(np.float64)

    a_lo, a_hi = split16(a)
    b_lo, b_hi = split16(b)
    fa_lo = np.fft.fft(a_lo * tw)
    fa_hi = np.fft.fft(a_hi * tw)
    fb_lo = np.fft.fft(b_lo * tw)
    fb_hi = np.fft.fft(b_hi * tw)

    def untwist_i32(f):
        # |conv sums| <= N * 2^31 * 2 < 2^53 even at N = 2^20: exact in f64,
        # exact in int64; the int32 cast is the mod-2^32 torus reduction.
        real = np.real(np.fft.ifft(f) * itw)
        return np.round(real).astype(np.int64).astype(np.int32)

    lo_lo = untwist_i32(fa_lo * fb_lo)
    cross = untwist_i32(fa_lo * fb_hi + fa_hi * fb_lo)
    with np.errstate(over="ignore"):
        out = lo_lo + (cross << 16)  # int32 wrap == mod 2^32
    return jnp.asarray(out)


# ---------------------------------------------------------------------------
# Kernel pre-packing (host side, once per key)
# ---------------------------------------------------------------------------


def pack_kernels_host(kernels: np.ndarray, bits: int, drop_limbs: int = 0) -> np.ndarray:
    """Prepare torus kernels for the conv backend.

    kernels: (..., R, C, N) torus ints (numpy). Returns int8 array of shape
    (..., C * (n_limbs - drop_limbs), R, N) — conv rhs layout (out-features,
    in-features, window) with the window axis FLIPPED so that XLA's
    correlation computes a true convolution.

    ``drop_limbs``: truncate the lowest 8*drop_limbs bits of every kernel
    (bootstrapping-key compression). The discarded bits act as extra uniform
    key noise of magnitude < 2^(8*drop_limbs) per coefficient — far below the
    gadget-decomposition floor for the shipped parameter sets — and cut the
    matmul work by drop_limbs/n_limbs.
    """
    limbs = limb_split_signed_host(kernels, bits)  # (..., R, C, N, L)
    if drop_limbs:
        limbs = limbs[..., drop_limbs:]
    limbs = np.moveaxis(limbs, -1, -2)  # (..., R, C, L', N)
    limbs = limbs[..., ::-1]  # flip window axis for XLA's correlation
    limbs = np.moveaxis(limbs, -4, -2)  # (..., C, L', R, N)
    shape = limbs.shape
    return np.ascontiguousarray(
        limbs.reshape(shape[:-4] + (shape[-4] * shape[-3], shape[-2], shape[-1])))


# ---------------------------------------------------------------------------
# Batched negacyclic convolution backends
# ---------------------------------------------------------------------------

_BACKEND = None  # "conv" | "matmul" | None: chosen by resolve_backend


def set_backend(name: str | None):
    global _BACKEND
    assert name in ("conv", "matmul", None)
    _BACKEND = name


def get_backend() -> str | None:
    return _BACKEND


def resolve_backend() -> str:
    """The product form in use: the one set with `set_backend`, else the
    circulant matmul on GPUs, where XLA refuses integer convolutions, and the
    convolution elsewhere."""
    if _BACKEND is not None:
        return _BACKEND
    return "matmul" if jax.default_backend() == "gpu" else "conv"


def _backend_fn():
    return _conv_backend if resolve_backend() == "conv" else _matmul_backend


def _conv_backend(digits, packed, bits):
    """digits (B, R, N) int8; packed (C*L, R, N) int8 pre-flipped.

    Returns folded negacyclic per-limb products (B, C*L, N) int32.
    """
    N = digits.shape[-1]
    u = lax.conv_general_dilated(
        digits, packed,
        window_strides=(1,), padding=[(N - 1, N - 1)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.int32,
    )  # (B, C*L, 2N-1)
    return u[..., :N] - jnp.pad(u[..., N:], [(0, 0), (0, 0), (0, 1)])


def _matmul_backend(digits, packed, bits):
    """Same contract as _conv_backend but via an explicit circulant matmul.

    Builds the negacyclic circulant of each kernel with a gather and contracts
    with an int8 dot. Used where integer convs do not lower (GPUs).
    The negated half of the circulant is re-derived in the torus domain
    (int32 negation wraps exactly) because int8 limbs cannot represent +128.
    """
    B, R, N = digits.shape
    CL = packed.shape[0]
    L = n_limbs_for(bits)
    C = CL // L
    k = packed[..., ::-1]  # un-flip back to natural order (CL, R, N)
    # reconstruct torus kernels, negate, re-split so -128 limbs are handled
    k_t = limb_combine(k.reshape(C, L, R, N).astype(jnp.int32), 8 * L, axis=1)
    neg = limb_split_signed(-k_t, 8 * L)  # (C, R, N, L)
    neg = jnp.moveaxis(neg, -1, 1).reshape(CL, R, N)
    kext = jnp.concatenate([k, neg], axis=-1)  # (CL, R, 2N) int8
    c = np.arange(N)[None, :]
    r = np.arange(N)[:, None]
    idx = (c - r) % (2 * N)  # out[c] takes kext[(c - r) mod 2N] (sign folded in)
    circ = kext[:, :, idx]  # (CL, R, N, N) int8
    mat = circ.transpose(1, 2, 0, 3).reshape(R * N, CL * N)
    out = jnp.dot(digits.reshape(B, R * N), mat, preferred_element_type=jnp.int32)
    return out.reshape(B, CL, N)


def negacyclic_extern_product(digits, packed, bits: int, out_polys: int,
                              limb_offset: int = 0):
    """out[b, c] = sum_r digits[b, r] (*) kernels[r, c]  (negacyclic, exact).

    digits: (B, R, N) int8 gadget digits (|d| <= 127).
    packed: (C * (n_limbs(bits) - limb_offset), R, N) int8 from
    `pack_kernels_host` (``limb_offset`` = its drop_limbs).
    Returns (B, C, N) torus ints (int32 for bits=32, int64 for bits=64).
    """
    folded = _backend_fn()(digits, packed, bits)  # (B, C*L', N) int32
    B, _, N = folded.shape
    L = n_limbs_for(bits) - limb_offset
    folded = folded.reshape(B, out_polys, L, N)
    dtype = jnp.int32 if bits <= 32 else jnp.int64
    out = jnp.zeros((B, out_polys, N), dtype)
    for m in range(L):
        out = out + (folded[:, :, m].astype(dtype) << (8 * (m + limb_offset)))
    return out


def pack_kernels_traced(kernels, bits: int):
    """In-graph version of `pack_kernels_host` for *runtime* torus kernels.

    kernels: (..., R, C, N) traced torus ints. Returns (..., C*L, R, N) int8
    in the exact layout `_conv_backend` consumes. Needed where the "key" side
    of a negacyclic contraction is itself a ciphertext computed on device —
    e.g. the KMS TLev accumulator (new_mk_internals.jl:185-207), which the
    reference forward-transforms at runtime (`fftlev = forward_transform(lev)`).
    """
    limbs = limb_split_signed(kernels, bits)  # (..., R, C, N, L)
    limbs = jnp.moveaxis(limbs, -1, -2)  # (..., R, C, L, N)
    limbs = limbs[..., ::-1]  # flip window for XLA correlation
    limbs = jnp.moveaxis(limbs, -4, -2)  # (..., C, L, R, N)
    s = limbs.shape
    return limbs.reshape(s[:-4] + (s[-4] * s[-3], s[-2], s[-1]))


def negacyclic_extern_product_batched_kernels_multirow(rows, packed,
                                                       bits: int):
    """Per-batch-element kernels, MANY digit-row groups per element.

    rows: (B, M, R, N) int8 — M independent digit-row groups that all
    contract against the SAME per-element kernel (e.g. the KMS TLev relin:
    the S accumulator polys x the digit limb-blocks share one runtime TLev
    sample). packed: (B, C*L, R, N) int8 from `pack_kernels_traced`.
    Returns raw folded products (B, M, C*L, N) int32 — kernel-limb and
    digit-block shift-combines are the caller's (their shifts differ).

    Why not vmap the M=1 contract per group: each per-element product then
    runs with a unit M dim — stacking the groups into M gives the
    runtime-kernel contraction a real matrix shape (the KMS relin phase was
    ~98% of the KMS gate at M=1)."""
    backend = _backend_fn()
    return jax.vmap(lambda d, k: backend(d, k, bits))(rows, packed)


def negacyclic_extern_product_batched_kernels(digits, packed, bits: int,
                                              out_polys: int):
    """Per-batch-element kernels: out[b, c] = sum_r digits[b, r] (*) k[b, r, c].

    digits: (B, R, N) int8; packed: (B, C*L, R, N) int8 from
    `pack_kernels_traced`. The product backend is vmapped over the pair —
    XLA lowers this to a batched contraction. Exact, same contract as
    `negacyclic_extern_product`.
    """
    backend = _backend_fn()
    folded = jax.vmap(lambda d, k: backend(d[None], k, bits)[0])(digits, packed)
    B, _, N = folded.shape
    L = n_limbs_for(bits)
    folded = folded.reshape(B, out_polys, L, N)
    dtype = jnp.int32 if bits <= 32 else jnp.int64
    out = jnp.zeros((B, out_polys, N), dtype)
    for m in range(L):
        out = out + (folded[:, :, m].astype(dtype) << (8 * m))
    return out


# ---------------------------------------------------------------------------
# Monomial multiplication (negacyclic barrel rotation)
# ---------------------------------------------------------------------------


def _negacyclic_shift_static(x, s: int):
    """x * X^s mod (X^N + 1) for a static integer shift s (any sign)."""
    N = x.shape[-1]
    s = s % (2 * N)
    neg = s >= N
    s = s % N
    if s:
        lo = x[..., N - s:]
        hi = x[..., : N - s]
        x = jnp.concatenate([-lo, hi], axis=-1)
    return -x if neg else x


def mul_by_monomial(x, shift):
    """Multiply polynomials (..., N) by X^shift mod (X^N + 1).

    If ``shift`` is a static python int, uses slicing. If it is a traced array
    broadcastable over the leading axes (per-batch shifts, as in blind rotate),
    uses a branch-free barrel rotator: log2(2N) conditional negacyclic rolls.
    Matches DarkIntegers' `mul_by_monomial` semantics used throughout the
    reference (e.g. bootstrap.jl:19-23, 56-60).
    """
    if isinstance(shift, (int, np.integer)):
        return _negacyclic_shift_static(x, int(shift))

    N = x.shape[-1]
    shift = jnp.asarray(shift)
    s = shift % (2 * N)  # (batch dims)
    # broadcast shift bits over trailing axes of x
    extra = x.ndim - s.ndim
    s_b = s.reshape(s.shape + (1,) * extra)
    out = x
    bit = 1
    while bit < N:
        rolled = _negacyclic_shift_static(out, bit)
        out = jnp.where((s_b & bit) != 0, rolled, out)
        bit <<= 1
    out = jnp.where((s_b & N) != 0, -out, out)
    return out


# ---------------------------------------------------------------------------
# Gadget decomposition
# ---------------------------------------------------------------------------


def decompose(x, decomp_length: int, log2_base: int, bits: int, offset: int):
    """Signed gadget decomposition of torus polynomials.

    x: (..., N) torus ints. Returns (..., decomp_length, N) int32 digits in
    [-B/2, B/2). Reference: tgsw.jl:112-138 (`decompose`): add the
    precomputed offset, extract base-B digits from the high bits, re-centre.
    """
    dtype = jnp.int32 if bits <= 32 else jnp.int64
    x = jnp.asarray(x, dtype)
    off = jnp.asarray(offset, dtype)
    mask = jnp.asarray((1 << log2_base) - 1, dtype)
    half = jnp.asarray(1 << (log2_base - 1), dtype)
    shifted = x + off
    digits = []
    for j in range(1, decomp_length + 1):
        d = ((shifted >> (bits - j * log2_base)) & mask) - half
        digits.append(d.astype(jnp.int32))
    return jnp.stack(digits, axis=-2)


def digits_to_i8_rows(digits, log2_base: int):
    """Flatten decomposition digits to int8 conv rows, limb-splitting when the
    base exceeds a byte.

    digits: (B, P, l, N) int32 (P = polys per sample). Returns
    (digit_limbs, (B, P*l*digit_limbs? , N)) — actually a list of per-limb row
    blocks [(B, P*l, N) int8, ...] so callers can shift-combine outputs.
    """
    if log2_base <= 8:
        return [digits.astype(jnp.int8)]
    nl = (log2_base + 8) // 8  # signed digit needs log2_base+1 bits
    limbs = limb_split_signed(digits, 32)  # (B, P, l, N, 4)
    return [limbs[..., m] for m in range(nl)]
