"""Serialization round-trips: the cloud/client file workflow
(src/KeyGen.cpp -> test/ -> src/Compute.cpp -> src/Decrypt.cpp)."""

import jax
import jax.numpy as jnp
import numpy as np

from torus_fhe_tpu.boot import api, gates
from torus_fhe_tpu.core.params import test_parameters as make_test_params
from torus_fhe_tpu.threshold import shares as sh
from torus_fhe_tpu.utils import serialize as ser

PARAMS = make_test_params(n=16, N=64)


def test_key_and_ciphertext_roundtrip(tmp_path):
    sk, ck = api.make_key_pair(jax.random.PRNGKey(0), PARAMS)
    msgs = jnp.array([True, False, True])
    ct = api.encrypt(jax.random.PRNGKey(1), sk, msgs)

    ser.save_secret_key(str(tmp_path / "secret.key"), sk)
    ser.save_cloud_key(str(tmp_path / "cloud.key"), ck)
    ser.save_lwe(str(tmp_path / "ct.data"), ct)

    sk2 = ser.load_secret_key(str(tmp_path / "secret.key"))
    ck2 = ser.load_cloud_key(str(tmp_path / "cloud.key"))
    ct2 = ser.load_lwe(str(tmp_path / "ct.data"))

    assert sk2.params == PARAMS
    np.testing.assert_array_equal(np.asarray(api.decrypt(sk2, ct2)), np.asarray(msgs))
    # evaluate with the reloaded cloud key
    out = gates.gate_and(ck2, ct2, ct2)
    np.testing.assert_array_equal(np.asarray(api.decrypt(sk2, out)), np.asarray(msgs))


def test_cloud_key_fast_form_roundtrip(tmp_path):
    """Saved keys are compact (raw TGSW samples); load rebuilds the requested
    product form(s) — incl. the F-block fast form — bit-identically to keygen's."""
    from torus_fhe_tpu.boot import bootstrap

    sk, ck = api.make_key_pair(jax.random.PRNGKey(3), PARAMS,
                               forms=("conv", "fblock"))
    path = str(tmp_path / "cloud.key")
    ser.save_cloud_key(path, ck)

    ck2 = ser.load_cloud_key(path)  # default: forms recorded at save
    assert ck2.bootstrap_key.kernels is not None
    assert ck2.bootstrap_key.fb is not None
    np.testing.assert_array_equal(np.asarray(ck2.bootstrap_key.kernels),
                                  np.asarray(ck.bootstrap_key.kernels))
    np.testing.assert_array_equal(np.asarray(ck2.bootstrap_key.fb),
                                  np.asarray(ck.bootstrap_key.fb))

    ck_fb = ser.load_cloud_key(path, forms=("fblock",))
    assert ck_fb.bootstrap_key.kernels is None
    msgs = jnp.array([True, False])
    ct = api.encrypt(jax.random.PRNGKey(4), sk, msgs)
    bootstrap.set_rotate_backend("fblock")
    try:
        out = gates.gate_nand(ck_fb, ct, ct)
    finally:
        bootstrap.set_rotate_backend("auto")
    np.testing.assert_array_equal(np.asarray(api.decrypt(sk, out)),
                                  ~np.asarray(msgs))


def test_share_set_roundtrip(tmp_path):
    key = np.random.default_rng(0).integers(0, 2, (1, 32)).astype(np.int32)
    repo = sh.share_secret_streaming(key, 2, 4, jax.random.PRNGKey(2))
    ser.save_share_set(str(tmp_path / "shares.npz"), repo)
    repo2 = ser.load_share_set(str(tmp_path / "shares.npz"))
    assert repo2.t == 2 and repo2.p == 4
    for k, v in repo.shares.items():
        np.testing.assert_array_equal(repo2.shares[k], v)


def test_mk_cloud_key_roundtrips(tmp_path):
    """All three MK schemes' cloud keys round-trip through files; the 3gen
    key rebuilds both product forms from the compact samples (tfhe_io parity,
    src/KeyGen.cpp:41-51)."""
    from torus_fhe_tpu import mk
    from torus_fhe_tpu.core.params import (test_parameters_3gen,
                                           test_parameters_ccs,
                                           test_parameters_kms)
    from torus_fhe_tpu.mk import ccs, kms

    p3 = test_parameters_3gen(2, n=16, N=64)
    sks = [mk.mk_party_keygen(jax.random.PRNGKey(60 + p), p3)
           for p in range(2)]
    ck = mk.mk_cloud_keygen(jax.random.PRNGKey(61), sks, p3,
                            forms=("conv", "fblock"), keep_samples=True)
    path = str(tmp_path / "mk3gen.key")
    ser.save_mk_cloud_key(path, ck)
    ck2 = ser.load_mk_cloud_key(path)
    np.testing.assert_array_equal(np.asarray(ck2.bk_kernels),
                                  np.asarray(ck.bk_kernels))
    np.testing.assert_array_equal(np.asarray(ck2.bk_fb),
                                  np.asarray(ck.bk_fb))
    assert ck2.parties == 2 and ck2.params == p3

    pc = test_parameters_ccs(2, n=16, N=64)
    csks = [ccs.ccs_party_keygen(jax.random.PRNGKey(70 + p), pc)
            for p in range(2)]
    cck = ccs.ccs_cloud_keygen(jax.random.PRNGKey(71), csks, pc)
    path = str(tmp_path / "ccs.key")
    ser.save_ccs_cloud_key(path, cck)
    cck2 = ser.load_ccs_cloud_key(path)
    for f in ("d_kern", "f0_kern", "f1_kern", "pk_kern", "sk_kern",
              "ks_mats"):
        np.testing.assert_array_equal(np.asarray(getattr(cck2, f)),
                                      np.asarray(getattr(cck, f)))
    assert cck2.params == pc

    pk = test_parameters_kms(2, n=16, N=64)
    ksks = [kms.kms_party_keygen(jax.random.PRNGKey(80 + p), pk)
            for p in range(2)]
    kck = kms.kms_cloud_keygen(jax.random.PRNGKey(81), ksks, pk)
    path = str(tmp_path / "kms.key")
    ser.save_kms_cloud_key(path, kck)
    kck2 = ser.load_kms_cloud_key(path)
    for f in ("gsw_kern", "d_kern", "ks_mats"):
        np.testing.assert_array_equal(np.asarray(getattr(kck2, f)),
                                      np.asarray(getattr(kck, f)))
    assert kck2.params == pk
