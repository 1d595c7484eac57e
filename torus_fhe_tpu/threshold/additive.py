"""Additive n-of-n key splitting with smudging — the TwoTwo/NN family.

Rework of the reference's additive-split experiments:

* ``src/TwoTwo.cpp`` — 2-of-2 additive split of an LWE key (:24-87) and of a
  TLWE key (:89-169): the key is split as s = s1 + s2 over the torus; each
  party publishes ``partial_i = <a, s_i> + smudge_i`` and the combiner decodes
  ``b - partial_1 - partial_2``. A smudging-bound sweep 1.0 -> 1e-2 locates
  the failure frontier (:202-206).
* ``src/TlweTwoTwo.cpp`` — the same on huge rings (N up to 2^20+, :53-55) with
  per-coefficient smudging (:26-31); here N is just an array dimension.
* ``src/NN.cpp`` — n parties decrypt sequentially with *sparse* smudging
  (``RandomSmudge``: only r of the N coordinates get noise, :17-31), sweeping
  parties 2..20 x bound to find the max tolerable smudging per party count
  (:117-127).

Design: the party axis is a leading batch axis — all partials are one
einsum/negacyclic product, and on several devices the party axis maps
onto the `party` mesh axis with the combine expressed as a psum
(parallel/mesh.py). Everything is exact wrapping integer arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng as trng
from ..lwe import LweKey, LweSample
from ..ops import poly
from ..rlwe import RLweKey, RLweSample


class AdditiveShares(NamedTuple):
    """p additive shares of a key: sum(shares, axis=0) == key (wrapping)."""

    shares: jax.Array  # (p, ...) torus ints


def split_additive(key, secret, parties: int, dtype=jnp.int32) -> AdditiveShares:
    """Split ``secret`` (any shape of small/torus ints) into ``parties``
    uniformly random additive shares (TwoTwo.cpp:31-38: s2 = s - s1).

    parties-1 shares are uniform torus ints; the last is the wrapping
    remainder, so every proper subset is information-theoretically random.
    """
    secret = jnp.asarray(secret, dtype)
    rand = trng.uniform_torus(key, (parties - 1,) + secret.shape, dtype)
    last = secret - jnp.sum(rand, axis=0, dtype=dtype)
    return AdditiveShares(jnp.concatenate([rand, last[None]], axis=0))


def split_lwe_key(key, lwe_key: LweKey, parties: int) -> AdditiveShares:
    return split_additive(key, lwe_key.key, parties)


def split_rlwe_key(key, rlwe_key: RLweKey, parties: int) -> AdditiveShares:
    # Share dtype must match the torus width the key encrypts (not the int32
    # key-storage dtype): rlwe_partial_decrypt multiplies mod 2^bits, so the
    # shares must sum to the key mod 2^bits, not just mod 2^32.
    dtype = jnp.int32 if rlwe_key.bits == 32 else jnp.int64
    return split_additive(key, rlwe_key.key, parties, dtype)


def lwe_partial_decrypt(sample: LweSample, shares: AdditiveShares, bound: float,
                        rng_key, sparse_coords: int | None = None):
    """All parties' partials in one batched contraction.

    partial_i = <a, s_i> + smudge_i  (TwoTwo.cpp:44-56). ``bound`` is the
    smudging noise stdev on the torus. For LWE, ``sparse_coords`` selects the
    NN.cpp behaviour of smudging only some partials (r of n coordinates of
    the *mask* contribution collapses to a scalar here, so sparsity acts on
    the party axis draw); None smudges every partial.

    sample.a: (..., n); shares: (p, n). Returns (p, ...) torus partials.
    """
    shares_arr = jnp.asarray(shares.shares)
    p = shares_arr.shape[0]
    dtype = sample.b.dtype
    # (p, ...) = contraction of (..., n) with (p, n) — one matmul
    partial = jnp.einsum("...n,pn->p...", sample.a.astype(dtype), shares_arr.astype(dtype))
    err = trng.gaussian_torus(rng_key, 0, bound, (p,) + sample.b.shape, dtype)
    if sparse_coords is not None:
        # LWE semantics differ from NN.cpp's RandomSmudge (which smudges r of
        # the N ring coordinates): an LWE partial is a single torus scalar per
        # ciphertext, so ``sparse_coords`` here means "~r of the ciphertext
        # batch get smudged" (the last axis of sample.b is the batch axis).
        # Validate r against that axis so a ring-style r > batch is an error.
        batch = sample.b.shape[-1] if sample.b.ndim else 1
        if sparse_coords > batch:
            raise ValueError(
                f"sparse_coords={sparse_coords} exceeds the LWE batch axis "
                f"({batch}); ring-coordinate sparsity (NN.cpp RandomSmudge) "
                "only applies to rlwe_partial_decrypt")
        mask = _sparse_mask(jax.random.fold_in(rng_key, 1),
                            (p,) + sample.b.shape, sparse_coords)
        err = err * mask
    return partial + err


def rlwe_partial_decrypt(sample: RLweSample, shares: AdditiveShares,
                         bound: float, rng_key,
                         sparse_coords: int | None = None):
    """Ring version (TwoTwo.cpp:113-143 / TlweTwoTwo.cpp:20-48).

    partial_i = sum_j shares_i[j] (*) a[j] + smudge_i, exact negacyclic mod
    2^bits. sample.a: (k+1, N); shares: (p, k, N). Returns (p, N).
    ``sparse_coords`` = r of NN.cpp's RandomSmudge: only r of the N
    coefficients of each party's smudging vector are nonzero (NN.cpp:17-31).
    """
    shares_arr = jnp.asarray(shares.shares)
    p = shares_arr.shape[0]
    a = sample.a[..., :-1, :]
    dtype = sample.a.dtype
    N = a.shape[-1]
    if N <= 4096 or shares_arr.dtype == jnp.int64:
        prods = poly.negacyclic_polymul_ref(shares_arr.astype(jnp.int64),
                                            a.astype(dtype))  # (p, k, N)
    else:
        # huge-ring sweeps (src/TlweTwoTwo.cpp:53-55, N = 2^20+): the exact
        # circulant would materialise (N, N); use the limb f64 FFT instead —
        # same approximation class as the reference's torusPolynomialAddMulR
        # partial-decrypt path, error orders below every smudging bound.
        prods = poly.negacyclic_polymul_fft64(
            shares_arr, jnp.broadcast_to(a.astype(dtype),
                                         shares_arr.shape[:1] + a.shape))
    partial = jnp.sum(prods, axis=-2, dtype=dtype)
    N = partial.shape[-1]
    err = trng.gaussian_torus(rng_key, 0, bound, (p, N), dtype)
    if sparse_coords is not None:
        err = err * _sparse_mask(jax.random.fold_in(rng_key, 1), (p, N),
                                 sparse_coords)
    return partial + err


def _sparse_mask(key, shape, r: int):
    """0/1 mask with ~r of the last-axis positions set per row (NN.cpp:17-31;
    the reference draws r coordinates with replacement — the same expected
    density, reproduced here branch-free with a per-position Bernoulli)."""
    N = shape[-1]
    keep = jax.random.uniform(key, shape) < (r / N)
    return keep.astype(jnp.int32)


def combine(sample, partials):
    """phase = b - sum_i partial_i (TwoTwo.cpp:60-66). Works for both LWE
    samples (b scalar per ciphertext) and RLWE samples (b = last mask poly)."""
    partials = jnp.asarray(partials)
    b = sample.b if isinstance(sample, LweSample) else sample.a[..., -1, :]
    return b - jnp.sum(partials, axis=0, dtype=partials.dtype)


def max_tolerable_bound(decrypt_ok, bounds) -> float:
    """Failure-frontier search: the largest bound whose decryption stays
    correct (the sweep loops of TwoTwo.cpp:202-206 / NN.cpp:117-127).

    ``decrypt_ok``: callable bound -> bool. Returns 0.0 if none pass.
    """
    best = 0.0
    for bnd in sorted(bounds):
        if decrypt_ok(float(bnd)):
            best = float(bnd)
    return best
