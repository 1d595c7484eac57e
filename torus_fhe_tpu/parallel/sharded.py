"""Party-axis sharded execution: `shard_map` + `psum` over the device mesh.

Replacement for the reference's cross-party reductions:

* the multikey keyswitch sums per-party contributions
  ``result += keyswitch(ks[p], a_p)`` (mk_keyswitch_3gen,
  3-gen-mk-tfhe/src/mk_internals.jl:712-744 — the ``reduce(+, ...)`` targets
  at :90, :724, :742);
* threshold decryption accumulates per-party partials under an OpenMP
  critical section (src/threshold_decryption_functions.cpp:407-431) before
  the signed combine (:479-508);
* the additive n-of-n combine sums all parties' partials
  (src/TwoTwo.cpp:60-66).

Here each mesh slice along the ``party`` axis owns its parties' key material
(keyswitch tables / key shares), computes its contributions locally, and the
cross-party sum is ONE `psum` over the mesh — no host round-trips. Every
function is the bit-exact equal of its single-device counterpart (asserted in
tests/test_multichip.py on a virtual 8-device mesh).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..lwe import LweSample
from ..mk.keys3gen import MKCloudKey
from ..mk.samples import MKLweSample
from ..ops import poly
from .mesh import PARTY_AXIS


def _party_size(mesh: Mesh) -> int:
    return mesh.shape[PARTY_AXIS]


def pad_parties(arr, parties: int, mesh_parties: int, axis: int = 0):
    """Zero-pad a party-leading array so the party axis divides the mesh axis.

    Padded slots hold zero key material and therefore contribute exactly zero
    to every psum below.
    """
    total = -(-parties // mesh_parties) * mesh_parties
    if total == parties:
        return arr, total
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, total - parties)
    return jnp.pad(arr, pad_width), total


# ---------------------------------------------------------------------------
# Multikey keyswitch, party-sharded
# ---------------------------------------------------------------------------


def mk_ks_tables_sharded(ck: MKCloudKey, mesh: Mesh):
    """Reshape the party-concatenated keyswitch table (K, P*(n+1)*4) into a
    party-leading (P_padded, K, (n+1)*4) array sharded over the mesh's party
    axis. Do this once at setup; feed the result to mk_keyswitch_sharded."""
    n = ck.params.lwe_size
    K = ck.ks_mat.shape[0]
    tables = ck.ks_mat.reshape(K, ck.parties, (n + 1) * 4)
    tables = jnp.swapaxes(tables, 0, 1)  # (P, K, (n+1)*4)
    tables, total = pad_parties(tables, ck.parties, _party_size(mesh))
    sharding = NamedSharding(mesh, P(PARTY_AXIS))
    return jax.device_put(tables, sharding)


def mk_keyswitch_sharded(ck: MKCloudKey, tables, u: LweSample,
                         mesh: Mesh) -> MKLweSample:
    """Party-sharded multikey keyswitch (mk_keyswitch_3gen,
    mk_internals.jl:730-744).

    Every device computes the one-hot digit matrix of the SAME extracted
    sample, applies its local parties' tables, and the b-part reduces with a
    single psum over the party axis. The per-party mask rows stay sharded
    (that is their natural layout: MKLweSample.a is (..., P, n)).

    ``tables``: from mk_ks_tables_sharded. Returns an MKLweSample whose a is
    (..., P_padded, n) party-sharded; slice [..., :ck.parties, :] when
    gathering to one device.
    """
    params = ck.params
    ksp = params.ks
    l, lb = ksp.decomp_length, ksp.log2_base
    base = 1 << lb
    n = params.lwe_size
    lead = u.b.shape

    def local(tables_loc, a, b):
        # tables_loc: (P_loc, K, (n+1)*4); a: (..., N_in); b: (...,)
        prec_offset = jnp.int32(1 << (32 - (1 + lb * l)))
        aibar = a + prec_offset
        j = np.arange(1, l + 1, dtype=np.int32)
        digits = (aibar[..., None] >> (32 - j * lb)) & (base - 1)
        h = np.arange(1, base, dtype=np.int32)
        onehot = (digits[..., None] == h).astype(jnp.int8).reshape(lead + (-1,))
        # (..., K) @ (P_loc, K, M) -> (..., P_loc, M)
        deltas = jnp.einsum("...k,pkm->...pm", onehot, tables_loc,
                            preferred_element_type=jnp.int32)
        deltas = deltas.reshape(lead + (tables_loc.shape[0], n + 1, 4))
        deltas = poly.limb_combine(deltas, 32, axis=-1)  # (..., P_loc, n+1)
        a_out = -deltas[..., :n]
        b_sum = jax.lax.psum(jnp.sum(deltas[..., n], axis=-1, dtype=jnp.int32),
                             PARTY_AXIS)
        return a_out, b - b_sum

    spec_b = P()  # u replicated across the party axis
    a_sh, b_sh = shard_map(
        local, mesh=mesh,
        in_specs=(P(PARTY_AXIS), spec_b, spec_b),
        out_specs=(P(*(None,) * len(lead), PARTY_AXIS), spec_b),
        check_vma=False,
    )(tables, u.a, u.b)
    return MKLweSample(a_sh, b_sh)


# ---------------------------------------------------------------------------
# Threshold partial decrypt + signed combine, party-sharded
# ---------------------------------------------------------------------------


def threshold_decrypt_sharded(sample_a, shares, signs, sd: float, rng_key,
                              mesh: Mesh):
    """Sharded t-party threshold decryption of a ring sample.

    Each device computes its local parties' partials
    ``partial_i = sum_j shares_i[j] (*) a[j] + smudge_i`` (partialDecrypt,
    src/threshold_decryption_functions.cpp:443-476) and the signed combine
    ``b + sum_i signs_i * partial_i`` (finalDecrypt, :479-508) happens as one
    psum over the party axis.

    sample_a: (k+1, N) torus; shares: (t, k, N) small ints; signs: (t,)
    (+1/-1 per party; the repo convention is party 0 carries -1). Both shares
    and signs are zero-padded to the mesh party size. Returns the plaintext
    polynomial (N,), replicated.
    """
    shares = jnp.asarray(shares)
    signs = jnp.asarray(signs, jnp.int32)
    t = shares.shape[0]
    mp = _party_size(mesh)
    shares, total = pad_parties(shares, t, mp)
    signs, _ = pad_parties(signs, t, mp)
    # per-party independent smudging keys, split on the party axis
    keys = jax.random.split(rng_key, total)

    a = sample_a[..., :-1, :]  # (k, N)
    b = sample_a[..., -1, :]  # (N,)
    N = b.shape[-1]
    dtype = sample_a.dtype

    def local(shares_loc, signs_loc, keys_loc, a):
        from ..core import rng as trng

        # exact negacyclic circulant product on-device (k, N small here;
        # huge-ring additive flows use ops/poly.negacyclic_polymul_fft64)
        prods = poly.negacyclic_polymul_ref(shares_loc.astype(jnp.int64),
                                            a.astype(dtype))
        partial = jnp.sum(prods, axis=-2, dtype=dtype)  # (t_loc, N)
        err = jax.vmap(lambda k: trng.gaussian_torus(k, 0, sd, (N,), dtype))(keys_loc)
        partial = partial + err
        contrib = jnp.sum(signs_loc[:, None].astype(dtype) * partial, axis=0,
                          dtype=dtype)
        return jax.lax.psum(contrib, PARTY_AXIS)

    out = shard_map(
        local, mesh=mesh,
        in_specs=(P(PARTY_AXIS), P(PARTY_AXIS), P(PARTY_AXIS), P()),
        out_specs=P(),
        check_vma=False,
    )(shares, signs, keys, a)
    return b + out
