"""F-block blind rotation (ops/fblock.py): bit-exactness against the
limb-kernel scan path and the schoolbook oracle.

Mirrors the reference's `_wo_FFT` exact-twin test pattern
(3-gen-mk-tfhe/src/tgsw.jl:152-156): every fast kernel form must reproduce the
exact-arithmetic result bit for bit (drop_limbs=0), and end-to-end gates must
decrypt correctly with the shipped drop_limbs=1 compression.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torus_fhe_tpu.boot import api, bootstrap, gates
from torus_fhe_tpu.core.params import SchemeParams, test_parameters as make_test_params
from torus_fhe_tpu.core.torus import decode_message
from torus_fhe_tpu.ops import fblock
from torus_fhe_tpu.rlwe import rlwe_noiseless_trivial


def _exact_params(n=12, N=64):
    return make_test_params(n=n, N=N)


def _keys_and_inputs(params, B=4, seed=0):
    key = jax.random.PRNGKey(seed)
    sk, ck = api.make_key_pair(key, params, forms=("conv", "fblock"))
    rng = np.random.default_rng(seed + 1)
    N = params.rlwe_polynomial_degree
    acc = rlwe_noiseless_trivial(
        jnp.asarray(rng.integers(-2**31, 2**31, (B, N), dtype=np.int64),
                    jnp.int32),
        params.rlwe, (B,))
    bara = jnp.asarray(rng.integers(0, 2 * N, (B, params.lwe_size),
                                    dtype=np.int64), jnp.int32)
    return sk, ck, acc, bara


@pytest.mark.parametrize("N", [64, 256])
def test_fblock_matches_scan(N):
    params = _exact_params(N=N)
    sk, ck, acc, bara = _keys_and_inputs(params)
    geom = bootstrap._bk_geometry(params)
    tg = params.tgsw

    ref = bootstrap.blind_rotate(acc, bootstrap.BootstrapKey(ck.bootstrap_key.kernels),
                                 bara, params).a
    got = fblock.blind_rotate_fblock(acc.a, ck.bootstrap_key.fb, bara, geom,
                                     tg.decomp_length, tg.log2_base, tg.offset)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


@pytest.mark.parametrize("B", [1, 3])
def test_contraction_exact_at_fast_set_width(B):
    """One F-block step at the real tfhe_128_tpu_fast geometry (N=512, k=2,
    l=2, 11 limb columns: a (4B, 6144) @ (6144, 1408) int8 dot) against the
    schoolbook — the comparison chip_smoke.py makes on the card at B=4096."""
    import chip_smoke

    chip_smoke.check_fblock_contraction(B, np.random.default_rng(B))


@pytest.mark.parametrize("bits", [32, 64])
def test_resolver_picks_fblock_scan(bits):
    """"auto" runs the F-block scan whenever the key has an F-block form, at
    either torus width, and it matches the limb-kernel scan bit for bit."""
    params = make_test_params(n=4, N=64, bits=bits)
    _, ck = api.make_key_pair(jax.random.PRNGKey(bits), params,
                              forms=("conv", "fblock"))
    bk = ck.bootstrap_key
    assert bootstrap._resolve_backend(bk) == "fblock"
    assert bootstrap._resolve_backend(bootstrap.BootstrapKey(bk.kernels)) \
        == "scan"
    dt = np.int32 if bits == 32 else np.int64
    rng = np.random.default_rng(bits)
    acc = rlwe_noiseless_trivial(
        jnp.asarray(rng.integers(-2**31, 2**31, (2, 64)).astype(dt)),
        params.rlwe, (2,))
    bara = jnp.asarray(rng.integers(0, 128, (2, 4)), jnp.int32)
    got = bootstrap.blind_rotate(acc, bk, bara, params).a
    ref = bootstrap.blind_rotate(acc, bootstrap.BootstrapKey(bk.kernels),
                                 bara, params).a
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_no_interpret_mode_in_library():
    """No library path runs a kernel in an interpreter or imports a
    platform-specific Pallas backend."""
    import pathlib

    import torus_fhe_tpu

    root = pathlib.Path(torus_fhe_tpu.__file__).parent
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "interpret=" not in text, path
        assert "pallas" not in text.lower(), path


@pytest.mark.parametrize("backend", ["fblock", "scan"])
def test_gate_and_truth_table(backend):
    params = _exact_params()
    key = jax.random.PRNGKey(3)
    sk, ck = api.make_key_pair(key, params, forms=("conv", "fblock"))
    xs = jnp.asarray([False, False, True, True])
    ys = jnp.asarray([False, True, False, True])
    cx = api.encrypt(jax.random.PRNGKey(4), sk, xs)
    cy = api.encrypt(jax.random.PRNGKey(5), sk, ys)
    bootstrap.set_rotate_backend(backend)
    try:
        out = gates.gate_and(ck, cx, cy)
    finally:
        bootstrap.set_rotate_backend("auto")
    dec = np.asarray(api.decrypt(sk, out))
    np.testing.assert_array_equal(dec, np.asarray(xs) & np.asarray(ys))


def test_fblock_drop_limbs_gate():
    """drop_limbs=1 compressed F-block key still decrypts gates correctly."""
    base = make_test_params(n=12, N=64)
    params = SchemeParams(**{**base.__dict__, "bk_drop_limbs": 1})
    sk, ck = api.make_key_pair(jax.random.PRNGKey(6), params, forms=("fblock",))
    xs = jnp.asarray([False, True, True, False])
    ys = jnp.asarray([True, True, False, False])
    cx = api.encrypt(jax.random.PRNGKey(7), sk, xs)
    cy = api.encrypt(jax.random.PRNGKey(8), sk, ys)
    bootstrap.set_rotate_backend("fblock")
    try:
        out = gates.gate_xor(ck, cx, cy)
    finally:
        bootstrap.set_rotate_backend("auto")
    dec = np.asarray(api.decrypt(sk, out))
    np.testing.assert_array_equal(dec, np.asarray(xs) ^ np.asarray(ys))


def test_rounded_body_bk_all_backends():
    """Rounded-body BK (body rounded to 2^8 at keygen, the SOUND r5
    compression — the r4 quantized-mask variant is withdrawn, see
    tests/test_quantized_mask_attack.py) with the l=2 Bg=2^8 gadget and a
    rank-2 module (k=2): the F-block body drop is lossless on the rounded
    key, so fblock == scan bit-exactly and every backend decrypts the gate
    correctly — the tiny-shape twin of tfhe_parameters_128_tpu_fast."""
    base = make_test_params(n=12, N=64)
    params = SchemeParams(**{**base.__dict__, "bs_decomp_length": 2,
                             "bs_log2_base": 8, "rlwe_mask_size": 2,
                             "bk_drop_limbs": 1})
    sk, ck = api.make_key_pair(jax.random.PRNGKey(11), params,
                               forms=("conv", "fblock"))
    geom = bootstrap._bk_geometry(params)
    assert len(geom.cols) == 11  # 2 masks x 4 limbs + body 3 limbs
    tg = params.tgsw

    rng = np.random.default_rng(12)
    N = params.rlwe_polynomial_degree
    acc = rlwe_noiseless_trivial(
        jnp.asarray(rng.integers(-2**31, 2**31, (3, N), dtype=np.int64),
                    jnp.int32), params.rlwe, (3,))
    bara = jnp.asarray(rng.integers(0, 2 * N, (3, params.lwe_size),
                                    dtype=np.int64), jnp.int32)
    ref = bootstrap.blind_rotate(
        acc, bootstrap.BootstrapKey(ck.bootstrap_key.kernels), bara, params).a
    got = fblock.blind_rotate_fblock(acc.a, ck.bootstrap_key.fb, bara, geom,
                                     tg.decomp_length, tg.log2_base, tg.offset)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))

    xs = jnp.asarray([False, True, True, False])
    ys = jnp.asarray([True, True, False, False])
    cx = api.encrypt(jax.random.PRNGKey(13), sk, xs)
    cy = api.encrypt(jax.random.PRNGKey(14), sk, ys)
    for backend in ("scan", "fblock"):
        bootstrap.set_rotate_backend(backend)
        try:
            out = gates.gate_and(ck, cx, cy)
        finally:
            bootstrap.set_rotate_backend("auto")
        dec = np.asarray(api.decrypt(sk, out))
        np.testing.assert_array_equal(dec, np.asarray(xs) & np.asarray(ys),
                                      err_msg=backend)
