"""Torus arithmetic over fixed-point integers (Torus32 = int32, Torus64 = int64).

Re-implementation of the torus numeric layer of the reference
(Torus-FHE: 3-gen-mk-tfhe/src/numeric-functions.jl:1-132). A real torus element
t in [-1/2, 1/2) is represented as round(t * 2^bits) stored in a signed integer
of width ``bits``; addition/subtraction/multiplication wrap naturally in two's
complement, which XLA integer arithmetic provides for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Torus32 = jnp.int32
Torus64 = jnp.int64


def torus_bits(dtype) -> int:
    """Bit width of a torus dtype."""
    return jnp.dtype(dtype).itemsize * 8


def encode_message(mu, message_space: int, dtype=Torus32):
    """Phase of message ``mu`` in a space of ``message_space`` elements.

    Reference: numeric-functions.jl:84-95 (``encode_message``/``encode_message64``).
    """
    bits = torus_bits(dtype)
    log2_ms = int(message_space).bit_length() - 1
    return (jnp.asarray(mu, dtype) << (bits - log2_ms)).astype(dtype)


def decode_message(phase, message_space: int):
    """Round a phase to the nearest of ``message_space`` equally spaced messages.

    Returns values in ``[-message_space/2, message_space/2)``.
    Reference: numeric-functions.jl:70-81 (``decode_message``/``decode_message64``).
    """
    phase = jnp.asarray(phase)
    bits = torus_bits(phase.dtype)
    log2_ms = int(message_space).bit_length() - 1
    one = jnp.asarray(1, phase.dtype)
    half = one << (bits - log2_ms - 1)
    return (phase + half) >> (bits - log2_ms)


def double_to_torus(d, dtype=Torus32):
    """Convert floats in [-0.5, 0.5) to torus ints, truncating toward zero.

    Reference: numeric-functions.jl:101-107 (``dtot32``/``dtot64``).
    Accepts float arrays; uses float64 host-side semantics where available but
    is precision-tolerant: errors below ~2^-24 relative are far beneath every
    noise floor in the schemes.
    """
    bits = torus_bits(dtype)
    d = jnp.asarray(d)
    scaled = d * np.float64(2.0) ** bits if d.dtype == jnp.float64 else d * np.float32(2.0) ** bits
    # trunc toward zero to match the reference's trunc(Int32, d * 2^32)
    return jnp.trunc(scaled).astype(dtype)


def t64_to_t32(x):
    """Torus64 -> Torus32 by keeping the top 32 bits (trunc toward zero).

    Reference: numeric-functions.jl:109-111 (``t64tot32``): trunc(Int32, x / 2^32),
    which is division truncating toward zero, not an arithmetic shift.
    """
    x = jnp.asarray(x, jnp.int64)
    q = x >> 32
    # adjust for trunc-toward-zero on negatives with nonzero remainder
    rem_nonzero = (x & jnp.int64(0xFFFFFFFF)) != 0
    q = q + jnp.where((x < 0) & rem_nonzero, jnp.int64(1), jnp.int64(0))
    return q.astype(jnp.int32)


def mod_switch_from_torus(phase, msize: int):
    """Nearest message in Z_msize for a torus phase (C++ tfhe modSwitchFromTorus32).

    Used by the threshold final decryption (src/threshold_decryption_functions.cpp:496
    with MSIZE=2). interv = 2^bits / msize; result = round(phase / interv) mod msize.
    """
    phase = jnp.asarray(phase)
    bits = torus_bits(phase.dtype)
    udt = jnp.uint32 if bits <= 32 else jnp.uint64
    uphase = jax.lax.bitcast_convert_type(phase, udt)
    interv = (1 << bits) // msize
    half = jnp.asarray(interv // 2, udt)
    return ((uphase + half) // jnp.asarray(interv, udt)
            % jnp.asarray(msize, udt)).astype(jnp.int32)


def noise_calc(m_torus, d_torus):
    """Signed torus distance between expected phase m and decrypted phase d.

    Reference: numeric-functions.jl:117-132 (``noise_calc``). Returns a float in
    (-0.5, 0.5]-ish, the wrapped difference d - m on the torus.
    """
    m = jnp.asarray(m_torus)
    bits = torus_bits(m.dtype)
    scale = np.float64(2.0) ** bits
    m = m.astype(jnp.float32) / np.float32(scale)
    d = jnp.asarray(d_torus).astype(jnp.float32) / np.float32(scale)
    diff = d - m
    # wrap into (-0.5, 0.5]
    diff = jnp.where(diff < -0.5, diff + 1.0, diff)
    diff = jnp.where(diff > 0.5, diff - 1.0, diff)
    return diff
