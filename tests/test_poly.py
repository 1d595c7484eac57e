"""Exactness tests for the negacyclic polynomial kernels.

Mirrors the reference's kernel-vs-oracle strategy (src/ntt-test.cpp:50-93 and
the Julia `_wo_FFT` twins): every int8 product path must agree bit-for-bit with an
independent schoolbook computation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from torus_fhe_tpu.ops import poly


def schoolbook_negacyclic(a, b, bits):
    """Independent numpy oracle (object ints: no overflow)."""
    N = len(a)
    mod = 1 << bits
    res = [0] * N
    for i in range(N):
        for j in range(N):
            t = i + j
            p = int(a[i]) * int(b[j])
            if t < N:
                res[t] += p
            else:
                res[t - N] -= p
    res = [((r + (mod >> 1)) % mod) - (mod >> 1) for r in res]
    return np.array(res, dtype=np.int64)


@pytest.mark.parametrize("bits", [32, 64])
def test_limb_split_roundtrip_host(bits):
    rng = np.random.default_rng(0)
    dt = np.int32 if bits == 32 else np.int64
    x = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, size=(64,), dtype=dt)
    limbs = poly.limb_split_signed_host(x, bits)
    assert limbs.dtype == np.int8
    back = np.zeros_like(x, dtype=np.int64)
    for m in range(limbs.shape[-1]):
        back += limbs[..., m].astype(np.int64) << (8 * m)
    assert np.array_equal(back.astype(dt), x)


def test_limb_split_roundtrip_traced():
    rng = np.random.default_rng(1)
    x = rng.integers(-2**31, 2**31 - 1, size=(128,), dtype=np.int32)
    limbs = jax.jit(lambda v: poly.limb_split_signed(v, 32))(jnp.asarray(x))
    limbs = np.asarray(limbs)
    host = poly.limb_split_signed_host(x, 32)
    assert np.array_equal(limbs, host)


@pytest.mark.parametrize("backend", ["conv", "matmul"])
@pytest.mark.parametrize("bits", [32, 64])
def test_negacyclic_extern_product_exact(backend, bits):
    """digits x torus kernels == schoolbook, for both product backends."""
    old = poly.get_backend()
    poly.set_backend(backend)
    try:
        rng = np.random.default_rng(2)
        B, R, C, N = 2, 3, 2, 32
        dt = np.int32 if bits == 32 else np.int64
        digits = rng.integers(-64, 64, size=(B, R, N)).astype(np.int8)
        kernels = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max,
                               size=(R, C, N), dtype=dt)
        packed = poly.pack_kernels_host(kernels, bits)
        out = poly.negacyclic_extern_product(
            jnp.asarray(digits), jnp.asarray(packed), bits, C)
        out = np.asarray(out)
        for b in range(B):
            for c in range(C):
                ref = sum(
                    schoolbook_negacyclic(digits[b, r], kernels[r, c], bits)
                    for r in range(R)).astype(dt)
                assert np.array_equal(out[b, c], ref), (backend, bits, b, c)
    finally:
        poly.set_backend(old)


def test_polymul_ref_matches_schoolbook():
    rng = np.random.default_rng(3)
    N = 32
    a = rng.integers(-2, 3, size=(N,)).astype(np.int32)
    b = rng.integers(-2**31, 2**31 - 1, size=(N,), dtype=np.int32)
    got = np.asarray(poly.negacyclic_polymul_ref(jnp.asarray(a), jnp.asarray(b)))
    ref = schoolbook_negacyclic(a, b, 32).astype(np.int32)
    assert np.array_equal(got, ref)


def test_mul_by_monomial_static_vs_reference():
    rng = np.random.default_rng(4)
    N = 16
    x = rng.integers(-100, 100, size=(N,)).astype(np.int32)
    for s in [0, 1, 5, N - 1, N, N + 3, 2 * N - 1, 2 * N, -1, -N, -N - 2]:
        got = np.asarray(poly.mul_by_monomial(jnp.asarray(x), s))
        # oracle: multiply by X^s in Z[X]/(X^N+1)
        ref = np.zeros(N, dtype=np.int64)
        for i in range(N):
            t = (i + s) % (2 * N)
            sign = 1 if t < N else -1
            ref[t % N] += sign * x[i]
        assert np.array_equal(got, ref.astype(np.int32)), s


def test_mul_by_monomial_dynamic_matches_static():
    rng = np.random.default_rng(5)
    B, N = 4, 32
    x = jnp.asarray(rng.integers(-100, 100, size=(B, 2, N)).astype(np.int32))
    shifts = np.array([0, 7, N + 5, 2 * N - 1], dtype=np.int32)
    got = poly.mul_by_monomial(x, jnp.asarray(shifts))
    for b in range(B):
        ref = poly.mul_by_monomial(x[b], int(shifts[b]))
        assert np.array_equal(np.asarray(got[b]), np.asarray(ref))


def test_decompose_reconstructs():
    """Gadget digits must reconstruct the rounded input (tgsw.jl contract)."""
    from torus_fhe_tpu.core.params import TGswParams

    rng = np.random.default_rng(6)
    for bits, l, lb in [(32, 3, 7), (32, 2, 10), (64, 2, 7)]:
        tp = TGswParams(l, lb, bits)
        dt = np.int32 if bits == 32 else np.int64
        x = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, size=(8, 16), dtype=dt)
        digits = np.asarray(poly.decompose(jnp.asarray(x), l, lb, bits, tp.offset))
        assert digits.min() >= -(1 << (lb - 1)) and digits.max() < (1 << (lb - 1))
        recon = np.zeros(x.shape, dtype=np.int64)
        for j in range(l):
            recon += digits[..., j, :].astype(np.int64) << (bits - (j + 1) * lb)
        # floor-style decomposition: reconstruction error < B^-l in torus units
        err = (recon - x.astype(np.int64)).astype(np.uint64)
        if bits < 64:
            err &= np.uint64((1 << bits) - 1)
            err = np.minimum(err, np.uint64(1 << bits) - err)
        else:
            err = np.minimum(err, np.uint64(0) - err)
        assert err.max() <= np.uint64(1 << (bits - l * lb))


def test_decompose_zero_is_zero():
    """decompose(0) == 0 — the branch-free bara==0 skip in blind rotate."""
    from torus_fhe_tpu.core.params import TGswParams

    for bits, l, lb in [(32, 3, 7), (64, 2, 7), (32, 2, 10)]:
        tp = TGswParams(l, lb, bits)
        z = jnp.zeros((4, 8), np.int32 if bits == 32 else np.int64)
        digits = np.asarray(poly.decompose(z, l, lb, bits, tp.offset))
        assert not digits.any()


def test_fft64_polymul_matches_ref():
    """Limb-f64-FFT product == exact circulant for full-range torus operands
    (both directions of magnitude), N up to 1024."""
    rng = np.random.default_rng(7)
    for N in (64, 1024):
        a = jnp.asarray(rng.integers(-2**31, 2**31, (3, N)), jnp.int32)
        b = jnp.asarray(rng.integers(-2**31, 2**31, (3, N)), jnp.int32)
        ref = poly.negacyclic_polymul_ref(a, b)
        got = poly.negacyclic_polymul_fft64(a, b)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))
