"""Key-recovery attack on quantized-mask BK generation (r5 security fix).

Round 4 shipped bootstrapping keys whose RLWE masks were rounded to a
2^mq grid at keygen ("lossless mask limb drop"), claiming security could
only improve. That claim is FALSE whenever the encryption noise is below
the mask grid (here: noise 2^-25 vs grid 2^-16): every published body is
a grid point plus sub-half-grid noise, so rounding the body to the grid
cancels the noise EXACTLY, leaving exact linear equations for the secret
key over Z_{2^mq} — and mod 2 they fall to Gaussian elimination. This
test performs the full attack: it recovers the entire RLWE secret key
from TWO published zero-encryptions in seconds.

The fix (this repo, r5): no shipped parameter set quantizes masks; F-block
mask columns always keep every limb (ops/fblock.default_cols); keygen
asserts bk_mask_quantum_bits == 0 (boot/bootstrap.bootstrap_keygen). Body
rounding (bk_drop_limbs) is unaffected — rounding a *finished* body is a
deterministic post-hoc degradation of a full-entropy sample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torus_fhe_tpu.core.params import (PARAMETER_REGISTRY, SchemeParams,
                                       tfhe_parameters_128_tpu,
                                       tfhe_parameters_128_tpu_fast)
from torus_fhe_tpu.rlwe import rlwe_encrypt_zero, rlwe_keygen


def _recover_key_mod2(a, b, mq, N):
    """Round bodies to the mask grid, solve the exact system mod 2."""
    q = 1 << mq
    b_grid = ((b.astype(np.int64) + q // 2) >> mq) << mq
    A2 = ((a.astype(np.int64) >> mq) & 1).astype(np.uint8)
    c2 = ((b_grid >> mq) & 1).astype(np.uint8)
    rows, rhs = [], []
    for smp in range(a.shape[0]):
        M = np.zeros((N, N), np.uint8)
        for i in range(N):
            # negacyclic conv matrix; signs vanish mod 2
            M[:, i] = np.roll(A2[smp], i)
        rows.append(M)
        rhs.append(c2[smp])
    Maug = np.concatenate(
        [np.concatenate(rows, 0), np.concatenate(rhs, 0)[:, None]], 1)
    R = Maug.shape[0]
    row, pivcol = 0, {}
    for col in range(N):
        piv = next((r for r in range(row, R) if Maug[r, col]), None)
        if piv is None:
            continue
        Maug[[row, piv]] = Maug[[piv, row]]
        for r in np.nonzero(Maug[:, col])[0]:
            if r != row:
                Maug[r] ^= Maug[row]
        pivcol[col] = row
        row += 1
    s = np.zeros(N, np.uint8)
    for col, r in pivcol.items():
        s[col] = Maug[r, N]
    return s, row


def test_full_key_recovery_from_quantized_mask_bk():
    """The r4 'fast' configuration (mask grid 2^16, noise 2^-25): total
    break — the secret key is recovered exactly from 2 published samples."""
    p = SchemeParams(630, 1 / 2**15, 1024, 1, 32, 2, 8, 1 / 2**25,
                     8, 2, 1 / 2**15, bk_drop_limbs=1,
                     bk_mask_quantum_bits=16)  # the withdrawn r4 set
    rp = p.rlwe
    rk = rlwe_keygen(jax.random.PRNGKey(42), rp)
    s_true = np.asarray(rk.key)[0]
    z = rlwe_encrypt_zero(jax.random.PRNGKey(7), p.bs_noise_stddev, rk, rp,
                          shape=(2,), mask_round_bits=16,
                          body_round_bits=8)
    a = np.asarray(z.a[:, 0])
    b = np.asarray(z.a[:, 1])
    s_rec, rank = _recover_key_mod2(a, b, 16, rp.polynomial_degree)
    assert rank == rp.polynomial_degree
    np.testing.assert_array_equal(s_rec.astype(np.int32), s_true)


def test_shipped_sets_do_not_quantize_masks():
    """No shipped parameter set may use the broken knob, and keygen refuses
    to build a quantized-mask BK."""
    for name, maker in PARAMETER_REGISTRY.items():
        params = maker()
        assert getattr(params, "bk_mask_quantum_bits", 0) == 0, name

    from torus_fhe_tpu.boot.bootstrap import bootstrap_keygen
    from torus_fhe_tpu.core.params import test_parameters
    from torus_fhe_tpu.lwe import lwe_keygen

    import dataclasses

    bad = dataclasses.replace(test_parameters(n=8, N=64),
                              bk_mask_quantum_bits=8)
    lk = lwe_keygen(jax.random.PRNGKey(0), bad.lwe)
    rk = rlwe_keygen(jax.random.PRNGKey(1), bad.rlwe)
    with pytest.raises(AssertionError, match="insecure"):
        bootstrap_keygen(jax.random.PRNGKey(2), bad.bs_noise_stddev, lk, rk,
                         bad)


def test_sound_sets_keep_full_masks():
    """The fixed tfhe_128_tpu* sets: every mask limb present in the F-block columns;
    only body limbs are dropped (rounded at keygen, zero info loss)."""
    from torus_fhe_tpu.boot.bootstrap import _bk_geometry
    from torus_fhe_tpu.ops.poly import n_limbs_for

    for params in (tfhe_parameters_128_tpu(), tfhe_parameters_128_tpu_fast()):
        geom = _bk_geometry(params)
        k = params.rlwe_mask_size
        nl = n_limbs_for(params.rlwe_bits)
        for j in range(k):
            mask_limbs = [sh for (pj, sh) in geom.cols if pj == j]
            assert len(mask_limbs) == nl, (j, geom.cols)
        body_limbs = [sh for (pj, sh) in geom.cols if pj == k]
        assert len(body_limbs) == nl - params.bk_drop_limbs
