"""Party-pipelined multikey blind rotation over the device mesh.

The AKÖ multikey blind rotate is a strictly sequential chain of parties*n
CMux steps (mk_blind_rotate_3gen, 3-gen-mk-tfhe/src/3gen_mk_internals.jl:78-84)
— but its KEY MATERIAL is the scaling problem: the expanded F-block form of
an 8-party production key is ~72 GB, beyond one card's 80 GB once anything
else is resident.

The layout: shard the F-block key along the *party* axis of the
mesh (each chip holds its parties' n steps, ~9 GB each) and pipeline the
accumulators through the chips GPipe-style — microbatch m enters party 0,
rotates through its n steps, then `ppermute`s to party 1's chip, while
party 0 starts microbatch m+1. With M microbatches over P parties the
pipeline bubble is the standard (P-1)/(M+P-1); all cross-chip traffic is the
(Bm, C, N) int32 accumulator passed between cards once per party — a few MB
per hop, vs gigabytes of key that never move.

This gives multikey at >=4 parties a fast path when one card cannot hold the
fast key: a mesh can. Bit-exact vs the single-chip
hi-word fast path (asserted in tests/test_mk_pipeline.py on the virtual
8-CPU mesh) because the step order is identical — party-major, matching
MKLweSample's (parties, n) mask layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.params import TGswParams
from ..lwe import LweSample
from ..mk.keys3gen import MKCloudKey, hi_round_samples, mk_fb_geometry
from ..ops import fblock
from .mesh import PARTY_AXIS


def build_sharded_mk_fb(ck_samples, params, parties: int, mesh: Mesh):
    """Expand the compact MK samples into the party-sharded F-block key.

    ck_samples: (parties*n, l, 2, 2, N) torus64 (host). Returns a
    (parties, n, D*R*bs, ncols*bs) int8 array sharded along PARTY_AXIS —
    each mesh slice materialises only its own parties' expansion, so the
    full key never exists on one device.
    """
    assert mesh.shape[PARTY_AXIS] == parties, \
        (mesh.shape, parties, "one mesh party-slice per party")
    n = params.lwe_size
    geom = _local_geom(params)
    samples = np.asarray(jax.device_get(ck_samples))
    hi = hi_round_samples(samples).reshape(parties, n, *samples.shape[1:])
    sharding = NamedSharding(mesh, P(PARTY_AXIS))
    # Expand each party's shard ON its target device and assemble the global
    # array from the per-device pieces — the full key never resides on any
    # single device (at 8 parties it wouldn't fit: module docstring).
    first = None
    cache: dict[int, jax.Array] = {}
    shards = []
    probe_shape = (parties, n, 1, 1)  # party split only; trailing dims ignored
    for dev, idx in sharding.addressable_devices_indices_map(probe_shape).items():
        p = idx[0].start if idx[0].start is not None else 0
        if p not in cache:
            with jax.default_device(dev):
                cache[p] = jnp.expand_dims(fblock.build_fblocks(hi[p], geom), 0)
        arr = cache[p]
        if first is None:
            first = arr
        if dev not in arr.devices():
            arr = jax.device_put(arr, dev)
        shards.append(arr)
    global_shape = (parties,) + tuple(first.shape[1:])
    return jax.make_array_from_single_device_arrays(global_shape, sharding,
                                                    shards)


def _local_geom(params):
    """32-bit F-block geometry of ONE party's n steps."""
    return fblock.fblock_geometry(
        params.lwe_size, params.rlwe_polynomial_degree,
        params.rlwe_mask_size, params.gsw_decomp_length, 32, 0)


def build_sharded_mk_sel(ck_samples, params, parties: int, mesh: Mesh):
    """Party-shard the COMPACT F-block key (the streamed/large-party form).

    ck_samples: (parties*n, l, 2, 2, N) torus64 (host). Returns a
    (parties, n, R, 2N, ncols) int8 array sharded along PARTY_AXIS — each
    chip holds its parties' compact lines (~256x smaller than the expanded
    form build_sharded_mk_fb ships) and expands them on the fly per step
    chunk inside the pipelined rotate (fblock.blind_rotate_streamed). This
    is the flagship >=4-party one-chip configuration run under the mesh.
    """
    assert mesh.shape[PARTY_AXIS] == parties, (mesh.shape, parties)
    n = params.lwe_size
    geom = _local_geom(params)
    samples = np.asarray(jax.device_get(ck_samples))
    hi = hi_round_samples(samples).reshape(parties, n, *samples.shape[1:])
    sharding = NamedSharding(mesh, P(PARTY_AXIS))
    first = None
    cache: dict[int, jax.Array] = {}
    shards = []
    probe_shape = (parties, n, 1, 1)
    for dev, idx in sharding.addressable_devices_indices_map(
            probe_shape).items():
        p = idx[0].start if idx[0].start is not None else 0
        if p not in cache:
            with jax.default_device(dev):
                cache[p] = jnp.expand_dims(
                    jnp.asarray(fblock.build_sel(hi[p], geom)), 0)
        arr = cache[p]
        if first is None:
            first = arr
        if dev not in arr.devices():
            arr = jax.device_put(arr, dev)
        shards.append(arr)
    global_shape = (parties,) + tuple(first.shape[1:])
    return jax.make_array_from_single_device_arrays(global_shape, sharding,
                                                    shards)


def mk_blind_rotate_pipelined(fb_sharded, bara, barb, mu32: int, params,
                              parties: int, mesh: Mesh,
                              microbatches: int = 4):
    """Pipelined multikey blind rotate: returns the final (B, C, N) int32
    accumulators (hi-word torus), replicated over the mesh.

    bara: (B, parties, n) int32 mod-switched masks (party-major, the
    MKLweSample layout); barb: (B,) int32; mu32: static int, the hi word of
    the 64-bit test-vector value. ``fb_sharded``: the party-sharded key,
    either pre-expanded (parties, n, rows, cols) from build_sharded_mk_fb
    or COMPACT (parties, n, R, 2N, ncols) from build_sharded_mk_sel — the
    compact form streams its expansion per step chunk on each chip.

    Schedule: T = M + P - 1 ticks. At tick t, the chip holding party p
    rotates microbatch (t - p) through its n local CMux steps and hands the
    accumulator to party p+1 (`ppermute`). Party 0 seeds each
    incoming microbatch with the X^{-barb} [mu..mu] step vector; party P-1
    banks finished microbatches. Inactive (bubble) ticks compute on zeros —
    branch-free.
    """
    assert mesh.shape[PARTY_AXIS] == parties, (mesh.shape, parties)
    B = bara.shape[0]
    M = microbatches
    assert B % M == 0, (B, M)
    Bm = B // M
    n = params.lwe_size
    geom = _local_geom(params)
    tg32 = TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 32)
    N, C = geom.N, geom.C

    bara_mb = bara.reshape(M, Bm, parties, n)
    barb_mb = barb.reshape(M, Bm)

    from ..ops import poly

    def local(fb_loc, bara_loc, barb_all):
        # fb_loc: (1, n, rows, cols); bara_loc: (M, Bm, 1, n)
        p = lax.axis_index(PARTY_AXIS)
        fb_loc = fb_loc[0]
        bara_loc = bara_loc[:, :, 0]  # (M, Bm, n)

        def init_acc(m_idx):
            """X^{-barb} * trivial([mu..mu]) for microbatch m_idx (clamped)."""
            m_idx = jnp.clip(m_idx, 0, M - 1)
            bb = lax.dynamic_index_in_dim(barb_all, m_idx, 0, False)  # (Bm,)
            tv = jnp.full((Bm, N), jnp.int32(mu32))
            tv = poly.mul_by_monomial(tv, -bb)
            acc = jnp.zeros((Bm, C, N), jnp.int32)
            return acc.at[:, C - 1].set(tv)

        def tick(carry, t):
            acc_prev, outputs = carry
            # hand the previous tick's result to the next party
            acc_in = lax.ppermute(
                acc_prev, PARTY_AXIS,
                [(i, (i + 1) % parties) for i in range(parties)])
            m_idx = t - p  # microbatch this party works on at tick t
            acc_in = jnp.where(jnp.equal(p, 0)[None, None, None],
                               init_acc(m_idx), acc_in)
            ba = lax.dynamic_index_in_dim(
                bara_loc, jnp.clip(m_idx, 0, M - 1), 0, False)  # (Bm, n)
            if fb_loc.ndim == 4:  # compact sel lines: streamed expansion
                acc_out = fblock.blind_rotate_streamed(
                    acc_in, fb_loc, ba, geom, tg32.decomp_length,
                    tg32.log2_base, tg32.offset)
            else:  # (n, rows, cols) pre-expanded F-block
                acc_out = fblock.blind_rotate_fblock(
                    acc_in, fb_loc, ba, geom, tg32.decomp_length,
                    tg32.log2_base, tg32.offset)
            # party P-1 banks its finished microbatch
            bank_idx = jnp.clip(m_idx, 0, M - 1)
            banked = lax.dynamic_update_index_in_dim(
                outputs, acc_out, bank_idx, 0)
            take = jnp.logical_and(jnp.equal(p, parties - 1),
                                   jnp.logical_and(m_idx >= 0, m_idx < M))
            outputs = jnp.where(take, banked, outputs)
            return (acc_out, outputs), None

        outputs0 = jnp.zeros((M, Bm, C, N), jnp.int32)
        acc0 = jnp.zeros((Bm, C, N), jnp.int32)
        (_, outputs), _ = lax.scan(tick, (acc0, outputs0),
                                   jnp.arange(M + parties - 1))
        # replicate the finished accumulators to every slice
        is_last = jnp.equal(p, parties - 1).astype(jnp.int32)
        return lax.psum(outputs * is_last, PARTY_AXIS)

    out = shard_map(
        local, mesh=mesh,
        in_specs=(P(PARTY_AXIS), P(None, None, PARTY_AXIS, None), P()),
        out_specs=P(),
        check_vma=False,
    )(fb_sharded, bara_mb, barb_mb)
    return out.reshape(B, C, N)


def mk_bootstrap_pipelined(ck: MKCloudKey, fb_sharded, mu, x, mesh: Mesh,
                           microbatches: int = 4):
    """Full pipelined MK bootstrap: pipelined rotate + extract + the standard
    per-party keyswitch (boot3gen.mk_keyswitch)."""
    from ..core.torus import decode_message
    from ..mk.boot3gen import mk_keyswitch
    from ..rlwe import RLweSample, rlwe_extract_sample

    params = ck.params
    N = params.rlwe_polynomial_degree
    lead = x.b.shape
    B = int(np.prod(lead)) if lead else 1
    bara = decode_message(x.a, 2 * N).astype(jnp.int32).reshape(
        B, ck.parties, -1)
    barb = decode_message(x.b, 2 * N).astype(jnp.int32).reshape(B)
    if isinstance(mu, (int, np.integer)):
        v = int(mu)
        mu32 = v >> 32 if abs(v) >= (1 << 31) else v
    else:
        v = int(np.asarray(jax.device_get(mu)).reshape(()))
        mu32 = v if jnp.asarray(mu).dtype == jnp.int32 else v >> 32
    acc = mk_blind_rotate_pipelined(fb_sharded, bara, barb, mu32, params,
                                    ck.parties, mesh,
                                    microbatches=microbatches)
    u = rlwe_extract_sample(RLweSample(acc))
    u = LweSample(u.a.reshape(lead + u.a.shape[-1:]), u.b.reshape(lead))
    # the rotate's output is replicated over the mesh; the keyswitch runs
    # where keygen committed the table
    return mk_keyswitch(ck, jax.device_put(u, ck.ks_mat.sharding))
