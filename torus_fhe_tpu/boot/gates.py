"""The bootstrapped boolean gate set, batch-first.

Rework of 3-gen-mk-tfhe/src/gates.jl: each two-input gate is one
affine combination of the input batches plus one gate bootstrap; NOT is free;
MUX costs two rotate-extracts and one keyswitch. All gates map (B,)-batches
of encrypted bits to (B,)-batches — the throughput unit of the whole
framework (BASELINE: bootsAND gates/s).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..lwe import LweSample, lwe_noiseless_trivial
from .api import CloudKey
from .bootstrap import bootstrap, bootstrap_wo_keyswitch
from .keyswitch import keyswitch


def _trivial_like(ck: CloudKey, x: LweSample, mu):
    return lwe_noiseless_trivial(mu, ck.params.lwe, x.b.shape)


def _encode_static(mu: int, message_space: int) -> int:
    """Pure-Python twin of core.torus.encode_message for int32: computed
    without touching jnp so importing this module never initialises the JAX
    backend (platform selection stays with the caller)."""
    log2_ms = message_space.bit_length() - 1
    v = (mu << (32 - log2_ms)) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


# plain Python ints precomputed at import (outside any trace): keeps the
# bootstrap test-vector mu static, so eager gate calls reuse one jitted
# program per mu (bootstrap.bootstrap)
_EIGHTHS = {s: _encode_static(s, 8) for s in (-1, 1)}
_QUARTERS = {s: _encode_static(s, 4) for s in (-1, 1)}
_EIGHTH = _EIGHTHS.__getitem__
_QUARTER = _QUARTERS.__getitem__


def gate_nand(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    t = _trivial_like(ck, x, _EIGHTH(1)) - x - y
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _EIGHTH(1), t, ck.params)


def gate_or(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    t = _trivial_like(ck, x, _EIGHTH(1)) + x + y
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _EIGHTH(1), t, ck.params)


def gate_and(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    t = _trivial_like(ck, x, _EIGHTH(-1)) + x + y
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _EIGHTH(1), t, ck.params)


def gate_xor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    t = _trivial_like(ck, x, _QUARTER(1)) + (x + y).scale(2)
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _EIGHTH(1), t, ck.params)


def gate_xnor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    t = _trivial_like(ck, x, _QUARTER(-1)) - (x + y).scale(2)
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _EIGHTH(1), t, ck.params)


def gate_not(ck: CloudKey, x: LweSample) -> LweSample:
    return -x


def gate_constant(ck: CloudKey, values) -> LweSample:
    values = jnp.asarray(values)
    mu = jnp.where(values, _EIGHTH(1), _EIGHTH(-1))
    return lwe_noiseless_trivial(mu, ck.params.lwe, values.shape)


def gate_nor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    t = _trivial_like(ck, x, _EIGHTH(-1)) - x - y
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _EIGHTH(1), t, ck.params)


def gate_andny(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    t = _trivial_like(ck, x, _EIGHTH(-1)) - x + y
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _EIGHTH(1), t, ck.params)


def gate_andyn(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    t = _trivial_like(ck, x, _EIGHTH(-1)) + x - y
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _EIGHTH(1), t, ck.params)


def gate_orny(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    t = _trivial_like(ck, x, _EIGHTH(1)) - x + y
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _EIGHTH(1), t, ck.params)


def gate_oryn(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    t = _trivial_like(ck, x, _EIGHTH(1)) + x - y
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _EIGHTH(1), t, ck.params)


def gate_mux(ck: CloudKey, x: LweSample, y: LweSample, z: LweSample) -> LweSample:
    """MUX(x, y, z) = x ? y : z — two rotate-extracts + one keyswitch
    (gates.jl:163-177)."""
    t1 = _trivial_like(ck, x, _EIGHTH(-1)) + x + y
    u1 = bootstrap_wo_keyswitch(ck.bootstrap_key, _EIGHTH(1), t1, ck.params)
    t2 = _trivial_like(ck, x, _EIGHTH(-1)) - x + z
    u2 = bootstrap_wo_keyswitch(ck.bootstrap_key, _EIGHTH(1), t2, ck.params)
    t3 = lwe_noiseless_trivial(_EIGHTH(1), ck.params.extracted_lwe, u1.b.shape) + u1 + u2
    return keyswitch(ck.keyswitch_key, ck.params.ks, t3)


BINARY_GATES = {
    "nand": gate_nand, "or": gate_or, "and": gate_and, "xor": gate_xor,
    "xnor": gate_xnor, "nor": gate_nor, "andny": gate_andny,
    "andyn": gate_andyn, "orny": gate_orny, "oryn": gate_oryn,
}
