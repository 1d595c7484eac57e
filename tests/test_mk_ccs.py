"""CCS (1st-gen) multikey TFHE tests, modelled on the reference's
"multikey NAND" testcase (3-gen-mk-tfhe/test/runtests.jl:62-102): full
keygen pipeline + NAND truth-table round trips, in-process parties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torus_fhe_tpu.core.params import test_parameters_ccs as _params_ccs
from torus_fhe_tpu.core.torus import encode_message
from torus_fhe_tpu.mk import ccs
from torus_fhe_tpu.mk.samples import mk_decrypt, mk_encrypt, mk_lwe_phase


@pytest.fixture(scope="module", params=[2, 3])
def ccs_setup(request):
    parties = request.param
    params = _params_ccs(parties=parties, n=16, N=64)
    key = jax.random.PRNGKey(7)
    ks = jax.random.split(key, parties)
    sks = [ccs.ccs_party_keygen(ks[p], params) for p in range(parties)]
    ck = ccs.ccs_cloud_keygen(jax.random.fold_in(key, 99), sks, params)
    return params, sks, ck


def test_ccs_encrypt_decrypt_roundtrip(ccs_setup):
    params, sks, ck = ccs_setup
    msgs = jnp.asarray([True, False, True, True, False])
    c = mk_encrypt(jax.random.PRNGKey(3), [s.lwe for s in sks], msgs, params)
    dec = mk_decrypt([s.lwe for s in sks], c)
    np.testing.assert_array_equal(np.asarray(dec), np.asarray(msgs))


def test_ccs_bootstrap_refreshes(ccs_setup):
    """Bootstrap output decrypts to the sign of the input phase and its noise
    stays within the 1/4 failure bound (runtests.jl:93-101 analogue)."""
    params, sks, ck = ccs_setup
    msgs = jnp.asarray([True, False, False, True])
    lwe_keys = [s.lwe for s in sks]
    c = mk_encrypt(jax.random.PRNGKey(5), lwe_keys, msgs, params)
    mu = encode_message(1, 8)
    out = jax.jit(lambda s: ccs.mk_bootstrap(ck, mu, s))(c)
    dec = np.asarray(mk_decrypt(lwe_keys, out))
    np.testing.assert_array_equal(dec, np.asarray(msgs))
    # |phase - mu_expected| < 1/16 (far inside the 1/4 bound)
    phase = np.asarray(mk_lwe_phase(out, lwe_keys)).astype(np.int64)
    expected = np.where(np.asarray(msgs), mu, -mu).astype(np.int64)
    err = np.abs((phase - expected).astype(np.int32).astype(np.float64)) / 2**32
    assert err.max() < 1 / 16, err


def test_ccs_gate_nand_truth_table(ccs_setup):
    params, sks, ck = ccs_setup
    lwe_keys = [s.lwe for s in sks]
    xs = jnp.asarray([False, False, True, True])
    ys = jnp.asarray([False, True, False, True])
    cx = mk_encrypt(jax.random.PRNGKey(11), lwe_keys, xs, params)
    cy = mk_encrypt(jax.random.PRNGKey(12), lwe_keys, ys, params)
    out = jax.jit(lambda a, b: ccs.mk_gate_nand(ck, a, b))(cx, cy)
    dec = np.asarray(mk_decrypt(lwe_keys, out))
    np.testing.assert_array_equal(dec, ~(np.asarray(xs) & np.asarray(ys)))


def test_ccs_fb_backend_bit_exact(ccs_setup):
    """The F-block fast backend (per-chunk expanded compact lines, int8
    matmuls) is BIT-IDENTICAL to the conv scan — same key material, 32-bit
    torus, no rounding anywhere (VERDICT r3 item 4: backend parity)."""
    params, sks, _ = ccs_setup
    parties = len(sks)
    key = jax.random.PRNGKey(7)
    # both forms from the same RNG stream -> identical key material
    ck2 = ccs.ccs_cloud_keygen(jax.random.fold_in(key, 99), sks, params,
                               forms=("conv", "fb"))
    assert ck2.d_sel is not None and ck2.pk_fb is not None
    lwe_keys = [s.lwe for s in sks]
    xs = jnp.array([False, False, True, True])
    ys = jnp.array([False, True, False, True])
    cx = mk_encrypt(jax.random.PRNGKey(1), lwe_keys, xs, params)
    cy = mk_encrypt(jax.random.PRNGKey(2), lwe_keys, ys, params)
    mu = encode_message(1, 8)
    temp = ccs.mk_lwe_noiseless_trivial(
        mu, params.lwe, parties, xs.shape) - cx - cy
    out_fb = ccs.mk_bootstrap(ck2, mu, temp)

    ck_conv = ccs.CCSCloudKey(ck2.d_kern, ck2.f0_kern, ck2.f1_kern,
                              ck2.pk_kern, ck2.sk_kern, ck2.ks_mats,
                              parties, params)
    out_conv = ccs.mk_bootstrap(ck_conv, mu, temp)
    np.testing.assert_array_equal(np.asarray(out_fb.a), np.asarray(out_conv.a))
    np.testing.assert_array_equal(np.asarray(out_fb.b), np.asarray(out_conv.b))
    dec = np.asarray(mk_decrypt(lwe_keys, out_fb))
    np.testing.assert_array_equal(dec, ~(np.asarray(xs) & np.asarray(ys)))


def test_ccs_fb_wide_digits():
    """Bg=2^9 (the 2-party registry gadget) exceeds a byte: the digit
    hi/lo-block split path of apply_fblock must stay bit-exact."""
    from torus_fhe_tpu.core.params import SchemeParamsCCS

    params = SchemeParamsCCS(12, 3.05e-5, 64, 1, 32, 3, 9, 3.72e-9, 8, 2,
                             3.05e-5, 2)
    key = jax.random.PRNGKey(11)
    sks = [ccs.ccs_party_keygen(jax.random.fold_in(key, p), params)
           for p in range(2)]
    ck = ccs.ccs_cloud_keygen(jax.random.fold_in(key, 99), sks, params,
                              forms=("conv", "fb"))
    lwe_keys = [s.lwe for s in sks]
    xs = jnp.array([False, True])
    ys = jnp.array([True, True])
    cx = mk_encrypt(jax.random.PRNGKey(1), lwe_keys, xs, params)
    cy = mk_encrypt(jax.random.PRNGKey(2), lwe_keys, ys, params)
    mu = encode_message(1, 8)
    temp = ccs.mk_lwe_noiseless_trivial(mu, params.lwe, 2, xs.shape) - cx - cy
    out_fb = ccs.mk_bootstrap(ck, mu, temp)
    ck_conv = ccs.CCSCloudKey(ck.d_kern, ck.f0_kern, ck.f1_kern, ck.pk_kern,
                              ck.sk_kern, ck.ks_mats, 2, params)
    out_conv = ccs.mk_bootstrap(ck_conv, mu, temp)
    np.testing.assert_array_equal(np.asarray(out_fb.a), np.asarray(out_conv.a))
    dec = np.asarray(mk_decrypt(lwe_keys, out_fb))
    np.testing.assert_array_equal(dec, ~(np.asarray(xs) & np.asarray(ys)))
