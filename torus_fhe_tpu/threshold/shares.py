"""Benaloh–Leichter (t,T)-threshold sharing of ring-LWE secret keys.

Rework of the reference's threshold key-sharing layer
(src/threshold_decryption_functions.cpp:4-354, src/libthfhe.cpp:80-267).
The access structure is the monotone formula OR over all C(p,t) groups of
(AND over the group's t parties); its Benaloh–Leichter distribution matrix M
is block-structured (optAndCombineT/optOrCombineT,
threshold_decryption_functions.cpp:113-156), and the share computation is the
integer matmul  S = M · ρ  — the reference's cblas_dgemm hot spot (:194-222)
— which here is one int32 `jnp.dot`.

Two equivalent generators, as in the reference:
  * `share_secret`          — materialise M and ρ, one matmul (:269-285)
  * `share_secret_streaming`— per-group on-the-fly ρ, O(k·t) memory per group
                              (`shareSecret2`, :287-336), vectorised over all
                              groups at once here.

Share semantics: within a group (sorted party ids p_1 < ... < p_t), party p_1
holds  s + Σ_j r_j  and party p_{i+1} holds r_{t-1-i}; the key reconstructs as
share_1 − share_2 − ... − share_t.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def ncr(n: int, r: int) -> int:
    """C(n, r) (memoised `ncrT`, threshold_decryption_functions.cpp:4-19)."""
    if r > n or n < 0 or r < 0:
        return 0
    return math.comb(n, r)


def find_parties(gid: int, t: int, p: int) -> list[int]:
    """Rank (1-based) -> the gid-th t-subset of {1..p} in lexicographic order
    (threshold_decryption_functions.cpp:225-244)."""
    out: list[int] = []
    mem = 0
    for i in range(1, p):
        tmp = ncr(p - i, t - mem - 1)
        if gid > tmp:
            gid -= tmp
        else:
            out.append(i)
            mem += 1
        if mem + (p - i) == t:
            out.extend(range(i + 1, p + 1))
            break
    return out


def find_group_id(parties: Sequence[int], t: int, p: int) -> int:
    """t-subset of {1..p} -> 1-based lexicographic rank
    (threshold_decryption_functions.cpp:339-354)."""
    pset = set(parties)
    mem = 0
    group = 1
    for i in range(1, p + 1):
        if i in pset:
            mem += 1
        else:
            group += ncr(p - i, t - mem - 1)
        if mem == t:
            break
    return group


def and_share_matrix(t: int, k: int) -> np.ndarray:
    """Distribution matrix of the t-party AND clause (`optAndCombineT`,
    threshold_decryption_functions.cpp:113-131): (kt, kt) with row-block 0 =
    [I I ... I] and row-block r = I at column block t-r."""
    eye = np.eye(k, dtype=np.int32)
    M = np.zeros((k * t, k * t), np.int32)
    for r in range(t):
        for c in range(t):
            if r == 0 or c == t - r:
                M[r * k:(r + 1) * k, c * k:(c + 1) * k] = eye
    return M


def build_distribution_matrix(t: int, k: int, p: int) -> np.ndarray:
    """OR of C(p,t) AND clauses (`buildDistributionMatrix` +
    `optOrCombineT`, threshold_decryption_functions.cpp:133-172).

    Shape: (C(p,t)·k·t, k + C(p,t)·k·(t-1)); the first k columns are shared by
    every group (they multiply the secret rows of ρ)."""
    groups = ncr(p, t)
    A = and_share_matrix(t, k)
    F, R = A[:, :k], A[:, k:]
    rows, rcols = A.shape[0], A.shape[1] - k
    M = np.zeros((groups * rows, k + groups * rcols), np.int32)
    for g in range(groups):
        M[g * rows:(g + 1) * rows, :k] = F
        M[g * rows:(g + 1) * rows, k + g * rcols:k + (g + 1) * rcols] = R
    return M


@dataclass
class ShareSet:
    """Repo of key shares, the device-side `shared_key_repo`
    (src/threshold_decryption_vars.hpp:10-11): (party, group) -> (k, N) int."""

    t: int
    p: int
    shares: Dict[Tuple[int, int], np.ndarray] = field(default_factory=dict)

    def get(self, party: int, group: int) -> np.ndarray:
        return self.shares[(party, group)]

    def party_shares(self, party: int) -> Dict[int, np.ndarray]:
        """All shares one party holds, keyed by group (`ThFHE::GetShareSet`,
        src/libthfhe.cpp:374-381)."""
        return {g: s for (q, g), s in self.shares.items() if q == party}

    def subset_shares(self, parties: Sequence[int]) -> np.ndarray:
        """Stacked (t, k, N) shares for a t-subset, ordered ascending.

        Dedupes and, like the reference CLI (src/TLwe_TN.cpp:24-42), requires
        at least t unique valid party ids, using the first t of them.
        """
        order = sorted({q for q in parties if 1 <= q <= self.p})
        if len(order) < self.t:
            raise ValueError(
                f"need at least {self.t} unique party ids in 1..{self.p} for "
                f"{self.t}-out-of-{self.p} threshold decryption, got {sorted(set(parties))}")
        order = order[: self.t]
        gid = find_group_id(order, self.t, self.p)
        return np.stack([self.get(q, gid) for q in order])


def _distribute(S: np.ndarray, t: int, p: int, k: int) -> ShareSet:
    """Slice the share matrix into per-(party, group) key shares
    (`distributeShares`, threshold_decryption_functions.cpp:247-266)."""
    repo = ShareSet(t, p)
    G = S.shape[0] // (k * t)
    S = S.reshape(G, t, k, -1)
    for g in range(1, G + 1):
        parties = find_parties(g, t, p)
        for i, party in enumerate(parties):
            repo.shares[(party, g)] = np.asarray(S[g - 1, i], np.int32)
    return repo


def share_secret(key, t: int, p: int, rng_key) -> ShareSet:
    """Matrix-form sharing: S = M·ρ as one matmul (`shareSecret`,
    threshold_decryption_functions.cpp:269-285).

    key: (k, N) int array (ring key coefficients). ρ's first k rows are the
    key; the rest uniform bits (`buildRho`, :175-191).
    """
    key = np.asarray(key, np.int32)
    k, N = key.shape
    M = build_distribution_matrix(t, k, p)
    e = M.shape[1]
    rho_rand = jax.random.bernoulli(rng_key, 0.5, (e - k, N)).astype(jnp.int32)
    rho = jnp.concatenate([jnp.asarray(key), rho_rand], axis=0)
    S = jnp.dot(jnp.asarray(M), rho, preferred_element_type=jnp.int32)
    return _distribute(np.asarray(jax.device_get(S)), t, p, k)


def share_secret_streaming(key, t: int, p: int, rng_key,
                           groups: Sequence[int] | None = None) -> ShareSet:
    """On-the-fly sharing without materialising M (`shareSecret2`,
    threshold_decryption_functions.cpp:287-336), vectorised over groups.

    ``groups``: optional subset of 1-based group ids to generate (the
    reference generates all C(p,t); pass a subset when C(p,t) is huge).
    """
    key = np.asarray(key, np.int32)
    k, N = key.shape
    if groups is None:
        groups = range(1, ncr(p, t) + 1)
    groups = list(groups)
    G = len(groups)
    # (G, t-1, k, N) random blocks r_0..r_{t-2} per group
    blocks = np.asarray(jax.device_get(
        jax.random.bernoulli(rng_key, 0.5, (G, max(t - 1, 1), k, N)))).astype(np.int32)

    from ..ops import native

    repo = ShareSet(t, p)
    if native.available() and t > 1:
        shares = native.bl_shares_stream(key, blocks[:, : t - 1])  # (G, t, k, N)
        for idx, g in enumerate(groups):
            for i, party in enumerate(find_parties(g, t, p)):
                repo.shares[(party, g)] = shares[idx, i]
        return repo
    for idx, g in enumerate(groups):
        parties = find_parties(g, t, p)
        repo.shares[(parties[0], g)] = key + blocks[idx, :t - 1].sum(0)
        for i in range(1, t):
            repo.shares[(parties[i], g)] = blocks[idx, t - 1 - i]
    return repo
