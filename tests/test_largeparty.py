"""The shipped >=16-party 3gen parameter rows, exercised for real.

VERDICT r2 item 6: the l=1, Bg=2^26, N=2048 gadget
(mktfhe_parameters_16party_3gen, reference 3-gen-mk-tfhe/src/mk_api.jl:214-220)
previously existed only in the registry. Here the >byte digit path gets a
direct exactness test at log2_base=26, and a 2-party NAND runs the full
keygen + bootstrap pipeline with the genuine 16-party gadget (few parties,
real gadget — the gadget is what was untested).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torus_fhe_tpu.core.params import TGswParams, mktfhe_parameters_16party_3gen
from torus_fhe_tpu.ops import poly


def test_decompose_exactness_log2base_26():
    """Signed base-2^26 decomposition reconstructs within the rounding bound
    and its int8 limb rows recombine to the digits exactly."""
    tg = TGswParams(1, 26, 64)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(-2**63, 2**63, (4, 64), dtype=np.int64))
    digits = poly.decompose(x, tg.decomp_length, tg.log2_base, tg.bits,
                            tg.offset)  # (4, 1, 64) int32
    d = np.asarray(digits).astype(np.int64)
    assert (np.abs(d) <= 2**25).all()
    # reconstruction: sum_j d_j * 2^(64 - j*26) approximates x to the
    # round-to-nearest bound 2^(64-26-1)
    recon = (d[:, 0] << (64 - 26)).astype(np.int64)
    err = (np.asarray(x) - recon).astype(np.int64)
    assert (np.abs(err.astype(np.float64)) <= 2.0 ** (64 - 26 - 1)).all()

    # byte-limb rows: digits = sum_m rows[m] * 2^(8m), each row int8
    rows = poly.digits_to_i8_rows(digits[:, None], tg.log2_base)
    got = sum(np.asarray(r).astype(np.int64) << (8 * m)
              for m, r in enumerate(rows))
    np.testing.assert_array_equal(got[:, 0], d)


@pytest.mark.slow
def test_16party_gadget_nand_two_parties():
    """Full keygen + NAND with the shipped 16-party gadget (l=1, Bg=2^26,
    N=2048, 64-bit torus) — run with 2 parties to keep CPU time bounded; the
    gadget/limb machinery is identical at any party count."""
    from torus_fhe_tpu import mk

    params = mktfhe_parameters_16party_3gen()
    sks = [mk.mk_party_keygen(jax.random.PRNGKey(90 + p), params)
           for p in range(2)]
    ck = mk.mk_cloud_keygen(jax.random.PRNGKey(91), sks, params)
    lwe_keys = [sk.lwe for sk in sks]
    xs = jnp.asarray([True, False])
    ys = jnp.asarray([True, True])
    cx = mk.mk_encrypt(jax.random.PRNGKey(92), lwe_keys, xs, params)
    cy = mk.mk_encrypt(jax.random.PRNGKey(93), lwe_keys, ys, params)
    out = mk.gates3gen.mk_gate_nand(ck, cx, cy)
    dec = np.asarray(mk.mk_decrypt(lwe_keys, out))
    np.testing.assert_array_equal(dec, ~(np.asarray(xs) & np.asarray(ys)))


def test_8party_streamed_gate_truth_table():
    """8-party NAND through the STREAMED compact F-block form at shrunken
    n/N — the one-chip >=4-party configuration (perf_comp 8p row runs
    exactly this form at the registry set). Fast tier: tiny sizes keep
    the 8-party keygen + 16*n-step chain under a minute on CPU."""
    from torus_fhe_tpu import mk
    from torus_fhe_tpu.core.params import test_parameters_3gen

    parties = 8
    params = test_parameters_3gen(parties=parties, n=6, N=64)
    sks = [mk.mk_party_keygen(jax.random.PRNGKey(800 + p), params)
           for p in range(parties)]
    ck = mk.mk_cloud_keygen(jax.random.PRNGKey(801), sks, params,
                            forms=("fbstream",))
    assert ck.bk_fb_sel is not None and ck.bk_fb is None  # streamed, hi-word
    lwe_keys = [sk.lwe for sk in sks]
    xs = jnp.asarray([False, False, True, True])
    ys = jnp.asarray([False, True, False, True])
    cx = mk.mk_encrypt(jax.random.PRNGKey(802), lwe_keys, xs, params)
    cy = mk.mk_encrypt(jax.random.PRNGKey(803), lwe_keys, ys, params)
    out = mk.gates3gen.mk_gate_nand(ck, cx, cy)
    dec = np.asarray(mk.mk_decrypt(lwe_keys, out))
    np.testing.assert_array_equal(dec, ~(np.asarray(xs) & np.asarray(ys)))
