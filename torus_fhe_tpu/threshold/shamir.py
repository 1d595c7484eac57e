"""Shamir (t,n) secret sharing of LWE key files over Z_8191.

Rework of src/KeySplit.cpp: each key coefficient becomes the
constant term of a random degree-(t-1) polynomial over the prime field
P = 8191; shards are evaluations at n distinct random points; any t shards
reconstruct via Lagrange interpolation at 0. Evaluation is one Vandermonde
matmul over the whole key (the per-coefficient loop of the reference,
KeySplit.cpp:66-95, becomes a batched axis).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

P = 8191  # KeySplit.cpp:4


def _inv_mod(x: int) -> int:
    return pow(x % P, P - 2, P)


class Shards(NamedTuple):
    t: int
    n: int
    xs: np.ndarray  # (n,) evaluation points
    fs: np.ndarray  # (n, ...) evaluations, one row per shard


def split_secret(secret, t: int, n: int, rng: np.random.Generator) -> Shards:
    """SplitSecret (KeySplit.cpp:66-95), batched over an array of secrets."""
    secret = np.asarray(secret) % P
    coeffs = np.concatenate(
        [secret[None], rng.integers(1, P, (t - 1,) + secret.shape)], axis=0)
    xs = np.empty(0, np.int64)
    while len(xs) < n:
        xs = np.unique(rng.integers(1, P, n * 2))[:n]
    rng.shuffle(xs)
    xs = xs[:n]
    # Vandermonde evaluation mod P: fs[i] = sum_j coeffs[j] * xs[i]^j
    powers = np.ones((n, t), np.int64)
    for j in range(1, t):
        powers[:, j] = powers[:, j - 1] * xs % P
    fs = np.tensordot(powers, coeffs, axes=(1, 0)) % P
    return Shards(t, n, xs, fs)


def reconstruct_secret(shards: Shards, use: Sequence[int] | None = None) -> np.ndarray:
    """Lagrange interpolation at 0 over any t shards
    (ReconstructSecret, KeySplit.cpp:97-118)."""
    idx = list(use) if use is not None else list(range(shards.t))
    assert len(idx) >= shards.t
    idx = idx[: shards.t]
    total = np.zeros(shards.fs.shape[1:], np.int64)
    for i in idx:
        lam = 1
        for j in idx:
            if i != j:
                lam = lam * (-int(shards.xs[j])) % P
                lam = lam * _inv_mod(int(shards.xs[i]) - int(shards.xs[j])) % P
        total = (total + shards.fs[i] * lam) % P
    return total % P


def split_key(key_bits: np.ndarray, t: int, n: int, seed: int = 0):
    """Shard a whole binary LWE key (SplitTfheKeyFile semantics,
    KeySplit.cpp:120-150): per-shard arrays plus the common xs."""
    rng = np.random.default_rng(seed)
    return split_secret(np.asarray(key_bits), t, n, rng)


def reconstruct_key(shards: Shards, use: Sequence[int] | None = None) -> np.ndarray:
    """Inverse of split_key; values in {0,1} come back exactly."""
    return reconstruct_secret(shards, use).astype(np.int32)
