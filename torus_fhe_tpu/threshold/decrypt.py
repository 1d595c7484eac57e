"""Threshold (partial + final) decryption of ring-LWE ciphertexts.

Rework of src/threshold_decryption_functions.cpp:399-508. Each of
the t parties computes  partial_i = Σ_j share_i[j] ⊛ a[j] + smudging_i ; the
combiner recovers  phase = b − partial_1 + partial_2 + ... + partial_t  and
decodes 32 message bits from the first 32 coefficients (MSIZE = 2).

The poly products are exact negacyclic int products mod 2^32 — matching the
reference's FFT `partialDecrypt` path (torusPolynomialAddMulR, :462). (The
reference's `thresholdDecrypt` variant additionally reduces coefficients mod
549755809793 inside `nonFFTmul2` (:394) before truncating to int32 — a lossy
artifact we deliberately do not replicate; decode tolerance hides it there.)

Party parallelism: the t partial decryptions are independent; they batch as a
leading axis here and map onto the `party` mesh axis (psum combine) in
parallel/mesh.py when parties live on distinct chips.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng as trng
from ..core.torus import mod_switch_from_torus
from ..ops import poly
from ..rlwe import RLweSample
from .shares import ShareSet, find_group_id


def partial_decrypt(sample: RLweSample, shares, sd: float, rng_key):
    """Per-party partial decryption with smudging noise
    (`partialDecrypt`, threshold_decryption_functions.cpp:443-476).

    sample.a: (k+1, N); shares: (t, k, N) small ints. Returns (t, N) torus.
    """
    shares = jnp.asarray(shares)
    t = shares.shape[0]
    a = sample.a[..., :-1, :]  # (k, N)
    dtype = sample.a.dtype
    N = a.shape[-1]
    if N <= 4096:
        # exact negacyclic products: small-int share x torus mask, sum over k
        prods = poly.negacyclic_polymul_ref(shares.astype(jnp.int64), a.astype(dtype))
    else:
        # huge rings (the reference's partialDecrypt is itself an approximate
        # f64 FFT, torusPolynomialAddMulR): limb FFT, error << smudging sd
        prods = poly.negacyclic_polymul_fft64(shares, jnp.broadcast_to(
            a.astype(dtype), shares.shape[:1] + a.shape))
    partial = jnp.sum(prods, axis=-2, dtype=dtype)  # (t, N)
    N = partial.shape[-1]
    err = trng.gaussian_torus(rng_key, 0, sd, (t, N), dtype)
    return partial + err


def final_decrypt(sample: RLweSample, partials):
    """Combine partials: b − p_1 + p_2 + ... (`finalDecrypt`,
    threshold_decryption_functions.cpp:479-508). Returns the plaintext poly."""
    partials = jnp.asarray(partials)
    b = sample.a[..., -1, :]
    signs = jnp.concatenate([-jnp.ones((1,), partials.dtype),
                             jnp.ones((partials.shape[0] - 1,), partials.dtype)])
    return b + jnp.sum(signs[:, None] * partials, axis=0, dtype=partials.dtype)


def threshold_decrypt(sample: RLweSample, repo: ShareSet,
                      parties: Sequence[int], sd: float, rng_key):
    """One-shot t-of-p threshold decryption (`thresholdDecrypt`,
    threshold_decryption_functions.cpp:399-441): partials + combine."""
    shares = repo.subset_shares(parties)
    partials = partial_decrypt(sample, shares, sd, rng_key)
    return final_decrypt(sample, partials)


def decode_bits(plaintext_poly, n_bits: int = 32, msize: int = 2) -> int:
    """Decode an integer from the first n_bits coefficients (MSIZE=2 decode,
    threshold_decryption_functions.cpp:496-498)."""
    bits = np.asarray(jax.device_get(
        mod_switch_from_torus(plaintext_poly[..., :n_bits], msize)))
    weights = (1 << np.arange(n_bits)).astype(object)
    return int((bits.astype(object) * weights).sum(-1))


def encode_bits(value: int, N: int, n_bits: int = 32, msize: int = 2,
                dtype=jnp.int32):
    """Pack n_bits of ``value`` into coefficients 0..n_bits-1 of a test
    polynomial (src/TLwe_TN.cpp:57-65: modSwitchToTorus32(bit, MSIZE))."""
    bits = [(value >> i) & 1 for i in range(n_bits)]
    interval_log = 1  # msize == 2
    assert msize == 2
    mu = np.zeros(N, np.int64)
    mu[:n_bits] = [b << 31 for b in bits]
    return jnp.asarray(mu.astype(np.int32) if dtype == jnp.int32 else mu, dtype)
