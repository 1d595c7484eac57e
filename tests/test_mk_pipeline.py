"""Party-pipelined multikey blind rotation (parallel/mk_pipeline.py).

The sharded GPipe-style rotate must be BIT-EXACT vs the single-device
hi-word fast path — the step order is identical, only the chips differ.
Runs on the virtual 8-CPU mesh like tests/test_multichip.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torus_fhe_tpu import mk
from torus_fhe_tpu.core.params import test_parameters_3gen as params_3gen
from torus_fhe_tpu.parallel import mesh as pmesh
from torus_fhe_tpu.parallel import mk_pipeline

PARTIES = 4
PARAMS = params_3gen(parties=PARTIES, n=6, N=64)


@pytest.fixture(scope="module")
def setup():
    sks = [mk.mk_party_keygen(jax.random.PRNGKey(200 + p), PARAMS)
           for p in range(PARTIES)]
    ck = mk.mk_cloud_keygen(jax.random.PRNGKey(201), sks, PARAMS,
                            forms=("conv", "fblock"), keep_samples=True)
    m = pmesh.make_mesh(n_batch=1, n_party=PARTIES,
                        devices=jax.devices()[:PARTIES])
    fb_sh = mk_pipeline.build_sharded_mk_fb(ck.bk_samples, PARAMS, PARTIES, m)
    return sks, ck, m, fb_sh


def test_pipelined_rotate_bit_exact_vs_single_device(setup):
    from torus_fhe_tpu.mk import boot3gen

    sks, ck, m, fb_sh = setup
    B = 8
    rng = np.random.default_rng(3)
    n_steps = PARTIES * PARAMS.lwe_size
    bara_flat = jnp.asarray(rng.integers(
        0, 2 * PARAMS.rlwe_polynomial_degree, (B, n_steps), dtype=np.int64),
        jnp.int32)
    barb = jnp.asarray(rng.integers(
        0, 2 * PARAMS.rlwe_polynomial_degree, (B,), dtype=np.int64),
        jnp.int32)
    mu = jnp.asarray(1 << 61, jnp.int64)
    mu32 = int(mu) >> 32

    acc_pipe = mk_pipeline.mk_blind_rotate_pipelined(
        fb_sh, bara_flat.reshape(B, PARTIES, -1), barb, mu32, PARAMS,
        PARTIES, m, microbatches=4)

    u_single = boot3gen._fast_rotate_extract(ck, mu, bara_flat, barb, B)
    from torus_fhe_tpu.rlwe import RLweSample, rlwe_extract_sample

    u_pipe = rlwe_extract_sample(
        RLweSample(np.asarray(jax.device_get(acc_pipe))))
    np.testing.assert_array_equal(np.asarray(u_pipe.a),
                                  np.asarray(jax.device_get(u_single.a)))
    np.testing.assert_array_equal(np.asarray(u_pipe.b),
                                  np.asarray(jax.device_get(u_single.b)))


def test_pipelined_gate_decrypts(setup):
    """Full bootstrap through the pipeline: NAND truth via the standard gate
    combine, decrypted against all parties' keys."""
    from torus_fhe_tpu.core.torus import encode_message
    from torus_fhe_tpu.mk.samples import (mk_decrypt, mk_encrypt,
                                          mk_lwe_noiseless_trivial)

    sks, ck, m, fb_sh = setup
    lwe_keys = [sk.lwe for sk in sks]
    xs = jnp.asarray([False, False, True, True] * 2)
    ys = jnp.asarray([False, True, False, True] * 2)
    cx = mk_encrypt(jax.random.PRNGKey(210), lwe_keys, xs, PARAMS)
    cy = mk_encrypt(jax.random.PRNGKey(211), lwe_keys, ys, PARAMS)
    t = mk_lwe_noiseless_trivial(encode_message(1, 8), PARAMS.lwe, PARTIES,
                                 xs.shape) - cx - cy
    out = mk_pipeline.mk_bootstrap_pipelined(
        ck, fb_sh, encode_message(1, 8, jnp.int64), t, m, microbatches=4)
    dec = np.asarray(mk_decrypt(lwe_keys, out))
    np.testing.assert_array_equal(dec, ~(np.asarray(xs) & np.asarray(ys)))


def test_pipelined_gate_with_committed_key(setup):
    """On an accelerator keygen commits the cloud key to one device
    (mk_cloud_keygen -> to_device) while the pipeline's output is replicated
    over the mesh: the keyswitch must still run, bit-identical."""
    from torus_fhe_tpu.core.torus import encode_message
    from torus_fhe_tpu.mk.samples import mk_encrypt, mk_lwe_noiseless_trivial

    sks, ck, m, fb_sh = setup
    committed = jax.device_put(ck, jax.devices()[0])
    lwe_keys = [sk.lwe for sk in sks]
    xs = jnp.asarray([False, True, True, False] * 2)
    cx = mk_encrypt(jax.random.PRNGKey(212), lwe_keys, xs, PARAMS)
    t = mk_lwe_noiseless_trivial(encode_message(1, 8), PARAMS.lwe, PARTIES,
                                 xs.shape) - cx - cx
    mu = encode_message(1, 8, jnp.int64)
    got = mk_pipeline.mk_bootstrap_pipelined(committed, fb_sh, mu, t, m)
    want = mk_pipeline.mk_bootstrap_pipelined(ck, fb_sh, mu, t, m)
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(want.b))


def test_pipelined_rotate_streamed_compact_key_bit_exact(setup):
    """The COMPACT party-sharded key (build_sharded_mk_sel) + per-chip
    streamed expansion must be bit-exact vs the expanded-key pipeline AND
    the single-device fast path — this is the flagship >=4-party
    configuration run under the mesh (VERDICT r4 item 10)."""
    from torus_fhe_tpu.mk import boot3gen

    sks, ck, m, fb_sh = setup
    sel_sh = mk_pipeline.build_sharded_mk_sel(ck.bk_samples, PARAMS, PARTIES,
                                              m)
    assert sel_sh.ndim == 5  # (parties, n, R, 2N, ncols) compact lines
    B = 8
    rng = np.random.default_rng(4)
    n_steps = PARTIES * PARAMS.lwe_size
    bara_flat = jnp.asarray(rng.integers(
        0, 2 * PARAMS.rlwe_polynomial_degree, (B, n_steps), dtype=np.int64),
        jnp.int32)
    barb = jnp.asarray(rng.integers(
        0, 2 * PARAMS.rlwe_polynomial_degree, (B,), dtype=np.int64),
        jnp.int32)
    mu = jnp.asarray(1 << 61, jnp.int64)

    acc_sel = mk_pipeline.mk_blind_rotate_pipelined(
        sel_sh, bara_flat.reshape(B, PARTIES, -1), barb, int(mu) >> 32,
        PARAMS, PARTIES, m, microbatches=4)
    acc_fb = mk_pipeline.mk_blind_rotate_pipelined(
        fb_sh, bara_flat.reshape(B, PARTIES, -1), barb, int(mu) >> 32,
        PARAMS, PARTIES, m, microbatches=4)
    np.testing.assert_array_equal(np.asarray(jax.device_get(acc_sel)),
                                  np.asarray(jax.device_get(acc_fb)))

    u_single = boot3gen._fast_rotate_extract(ck, mu, bara_flat, barb, B)
    from torus_fhe_tpu.rlwe import RLweSample, rlwe_extract_sample

    u_pipe = rlwe_extract_sample(
        RLweSample(np.asarray(jax.device_get(acc_sel))))
    np.testing.assert_array_equal(np.asarray(u_pipe.a),
                                  np.asarray(jax.device_get(u_single.a)))
