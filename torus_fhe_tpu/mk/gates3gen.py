"""3rd-gen multikey bootstrapped gates and integer circuits, batch-first.

Rework of 3-gen-mk-tfhe/src/3gen_mk_gates.jl. Gates are one affine
combination of MK ciphertext batches plus one multikey bootstrap; the integer
circuits (ripple adders, comparators, shift-add multiplier, conv2d) mirror the
reference's topology with the bit-position loops kept sequential (carry chain)
and everything else batched.

Word layout: an encrypted integer is one MKLweSample whose LEADING axis is the
bit position (width, ..., parties, n), LSB first — the reference's
Vector{MKLweSample} (mk_api.jl:576-589) turned into an array axis so whole
vectors of integers bootstrap together.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.torus import encode_message
from .boot3gen import mk_bootstrap
from .keys3gen import MKCloudKey
from .samples import MKLweSample, mk_lwe_noiseless_trivial


def _trivial_like(ck: MKCloudKey, x: MKLweSample, mu):
    return mk_lwe_noiseless_trivial(mu, ck.params.lwe, ck.parties, x.b.shape)


def _mu(ck) -> int:
    """The bootstrap test-vector value as a PURE PYTHON int: jnp ops always
    return tracers under jit, and a static mu lets eager gate calls reuse one
    jitted program per mu (boot3gen._eager_jit_dispatch)."""
    if ck.params.rlwe_bits == 32:
        return 1 << 29  # encode_message(1, 8) on the 32-bit torus
    if not jax.config.jax_enable_x64:
        # no real int64 available: deliver the hi word directly — valid for
        # the hi-word F-block fast path, the only 64-bit backend without x64
        from .keys3gen import mk_fb_supported

        assert ((ck.bk_fb is not None or ck.bk_fb_sel is not None)
                and mk_fb_supported(ck.params)), \
            "64-bit MK backends other than the hi-word fast path need " \
            "jax_enable_x64"
        return 1 << 29
    return 1 << 61  # encode_message(1, 8) on the 64-bit torus


def mk_gate_nand(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    t = _trivial_like(ck, x, encode_message(1, 8)) - x - y
    return mk_bootstrap(ck, _mu(ck), t)


def mk_gate_or(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    t = _trivial_like(ck, x, encode_message(1, 8)) + x + y
    return mk_bootstrap(ck, _mu(ck), t)


def mk_gate_and(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    t = _trivial_like(ck, x, encode_message(-1, 8)) + x + y
    return mk_bootstrap(ck, _mu(ck), t)


def mk_gate_3and(ck: MKCloudKey, x, y, z) -> MKLweSample:
    """3-input AND in one bootstrap (3gen_mk_gates.jl:56-66)."""
    t = _trivial_like(ck, x, encode_message(-1, 4)) + x + y + z
    return mk_bootstrap(ck, _mu(ck), t)


def mk_gate_xor(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    t = _trivial_like(ck, x, encode_message(1, 4)) + (x + y).scale(2)
    return mk_bootstrap(ck, _mu(ck), t)


def mk_gate_not(ck: MKCloudKey, x: MKLweSample) -> MKLweSample:
    return -x


def mk_gate_mux(ck: MKCloudKey, x, y, z) -> MKLweSample:
    """MUX(x, y, z) = x ? y : z — two bootstraps + combine (the reference's
    commented variant, 3gen_mk_gates.jl:93-150, normalised like gates.jl)."""
    from .boot3gen import mk_bootstrap_wo_keyswitch, mk_keyswitch

    u1 = mk_bootstrap_wo_keyswitch(
        ck, _mu(ck), _trivial_like(ck, x, encode_message(-1, 8)) + x + y)
    u2 = mk_bootstrap_wo_keyswitch(
        ck, _mu(ck), _trivial_like(ck, x, encode_message(-1, 8)) - x + z)
    from ..lwe import LweSample

    t3 = LweSample(u1.a + u2.a, u1.b + u2.b + encode_message(1, 8))
    return mk_keyswitch(ck, t3)


def mk_gate_nand_wb(ck: MKCloudKey, x, y) -> MKLweSample:
    """Affine part of NAND without the bootstrap — the reference's `_wb`
    variants (3gen_mk_gates.jl:16-21), used for noise/timing experiments."""
    return _trivial_like(ck, x, encode_message(1, 8)) - x - y


def mk_gate_or_wb(ck: MKCloudKey, x, y) -> MKLweSample:
    return _trivial_like(ck, x, encode_message(1, 8)) + x + y


def mk_gate_and_wb(ck: MKCloudKey, x, y) -> MKLweSample:
    return _trivial_like(ck, x, encode_message(-1, 8)) + x + y


def mk_gate_xor_wb(ck: MKCloudKey, x, y) -> MKLweSample:
    return _trivial_like(ck, x, encode_message(1, 4)) + (x + y).scale(2)


BINARY_GATES = {"nand": mk_gate_nand, "or": mk_gate_or, "and": mk_gate_and,
                "xor": mk_gate_xor}
BINARY_GATES_WB = {"nand": mk_gate_nand_wb, "or": mk_gate_or_wb,
                   "and": mk_gate_and_wb, "xor": mk_gate_xor_wb}


def mk_gate_constant(ck: MKCloudKey, values) -> MKLweSample:
    """Noiseless trivial MK encryption of boolean constants (the multikey
    analog of boot/gates.gate_constant; mk_lwe_noiseless_trivial,
    mk_internals.jl:94-96) — cloud-side plaintext constants for circuits."""
    values = jnp.asarray(values)
    mu = jnp.where(values, encode_message(1, 8), encode_message(-1, 8))
    return mk_lwe_noiseless_trivial(mu, ck.params.lwe, ck.parties, values.shape)


# ---------------------------------------------------------------------------
# Integer circuits (bit axis = leading axis, LSB first)
# ---------------------------------------------------------------------------


def _bit(x: MKLweSample, i: int) -> MKLweSample:
    return MKLweSample(x.a[i], x.b[i])


def _stack_bits(bits) -> MKLweSample:
    return MKLweSample(jnp.stack([b.a for b in bits]), jnp.stack([b.b for b in bits]))


def mk_add(ck: MKCloudKey, a: MKLweSample, b: MKLweSample, cin: MKLweSample,
           width: int, with_carry: bool = False) -> MKLweSample:
    """Ripple-carry adder (mk_add_3gen, 3gen_mk_gates.jl:183-200): per bit,
    XOR/AND halves batched into one two-gate bootstrap by concatenation."""
    out = []
    carry = cin
    for i in range(width):
        ai, bi = _bit(a, i), _bit(b, i)
        tmp1 = mk_gate_xor(ck, ai, bi)
        tmp2 = mk_gate_and(ck, ai, bi)
        out.append(mk_gate_xor(ck, tmp1, carry))
        tmp3 = mk_gate_and(ck, tmp1, carry)
        carry = mk_gate_or(ck, tmp2, tmp3)
    if with_carry:
        out.append(carry)
    return _stack_bits(out)


def mk_inv(ck: MKCloudKey, a: MKLweSample, one: MKLweSample, width: int) -> MKLweSample:
    """Bitwise NOT via XOR with an encrypted 1 (mk_inv_3gen,
    3gen_mk_gates.jl:223-234): all bits in ONE batched bootstrap."""
    ones = MKLweSample(jnp.broadcast_to(one.a, a.a.shape),
                       jnp.broadcast_to(one.b, a.b.shape))
    return mk_gate_xor(ck, a, ones)


def mk_sub(ck: MKCloudKey, a, b, one, width: int) -> MKLweSample:
    """a - b = a + ~b + 1 (mk_sub_3gen, 3gen_mk_gates.jl:237-245)."""
    return mk_add(ck, a, mk_inv(ck, b, one, width), one, width)


def mk_less(ck: MKCloudKey, a, b, one, width: int) -> MKLweSample:
    """a < b = sign(a - b) (mk_less_3gen, 3gen_mk_gates.jl:248-256)."""
    return _bit(mk_sub(ck, a, b, one, width), width - 1)


def mk_greater(ck: MKCloudKey, a, b, one, width: int) -> MKLweSample:
    return _bit(mk_sub(ck, b, a, one, width), width - 1)


def mk_leq(ck: MKCloudKey, a, b, one, width: int) -> MKLweSample:
    return mk_gate_xor(ck, mk_greater(ck, a, b, one, width), one)


def mk_geq(ck: MKCloudKey, a, b, one, width: int) -> MKLweSample:
    return mk_gate_xor(ck, mk_less(ck, a, b, one, width), one)


def mk_int_mul(ck: MKCloudKey, a, b, zero: MKLweSample, width: int) -> MKLweSample:
    """Shift-add multiplier, low ``width`` bits (mk_int_mul_3gen,
    3gen_mk_gates.jl:291-362). Partial products batch into one bootstrap.

    Deviation from the reference: its final accumulation reuses loop counter
    ``ctr`` (== width-2 after the loop), adding partial-product row width-2
    twice and never row width-1 (3gen_mk_gates.jl:336-353) — wrong results
    for general operands. Here the last row added is row width-1, so
    decrypt(mul(a, b)) == a*b mod 2^width (tests/test_mk_circuits.py).
    """
    if width == 1:
        return mk_gate_and(ck, a, b)
    # BArr[i, j] = a_j AND b_i — all width*width gates in one bootstrap
    aa = MKLweSample(jnp.broadcast_to(a.a[None], (width,) + a.a.shape),
                     jnp.broadcast_to(a.b[None], (width,) + a.b.shape))
    bb = MKLweSample(jnp.broadcast_to(b.a[:, None], (width,) + a.a.shape),
                     jnp.broadcast_to(b.b[:, None], (width,) + a.b.shape))
    barr = mk_gate_and(ck, aa, bb)  # (width_b, width_a, ...)

    result = [MKLweSample(barr.a[0, 0], barr.b[0, 0])]
    tmp_in = [MKLweSample(barr.a[0, j + 1], barr.b[0, j + 1]) for j in range(width - 1)]
    tmp_in.append(zero)
    for i in range(1, width - 1):
        row = [MKLweSample(barr.a[i, j], barr.b[i, j]) for j in range(width)]
        tmp = mk_add(ck, _stack_bits(tmp_in), _stack_bits(row), zero, width,
                     with_carry=True)
        result.append(_bit(tmp, 0))
        tmp_in = [_bit(tmp, j + 1) for j in range(width)]
    row = [MKLweSample(barr.a[width - 1, j], barr.b[width - 1, j])
           for j in range(width)]
    tmp = mk_add(ck, _stack_bits(tmp_in), _stack_bits(row), zero, width,
                 with_carry=True)
    for i in range(width + 1):
        if len(result) < 2 * width:
            result.append(_bit(tmp, i))
    return _stack_bits(result[:width])


def mk_word_constant(ck: MKCloudKey, word: MKLweSample, value: bool) -> MKLweSample:
    """A trivial constant BIT shaped like one bit of a bit-axis word (the
    trailing batch axes of ``word``)."""
    return mk_gate_constant(ck, jnp.full(word.b.shape[1:], value, bool))


def mk_subtract(ck: MKCloudKey, a: MKLweSample, b: MKLweSample,
                width: int) -> MKLweSample:
    """a - b = a + ~b + 1 over bit-axis MK words (the MK twin of
    circuits/words.subtract; difference, src/bootstrap_modules.cpp:284-339).
    Bit width-1 of the result is the borrow/sign bit."""
    one = mk_word_constant(ck, a, True)
    return mk_add(ck, a, mk_inv(ck, b, one, width), one, width)


def mk_mux_word(ck: MKCloudKey, sel: MKLweSample, a: MKLweSample,
                b: MKLweSample) -> MKLweSample:
    """Word-wide MUX: sel ? a : b — one batched double bootstrap across the
    whole word (the MK twin of circuits/words.mux_word)."""
    sel_w = MKLweSample(jnp.broadcast_to(sel.a, a.a.shape),
                        jnp.broadcast_to(sel.b, a.b.shape))
    return mk_gate_mux(ck, sel_w, a, b)


def mk_compare_swap(ck: MKCloudKey, a: MKLweSample, b: MKLweSample,
                    width: int):
    """(min, max) of two encrypted MK words via subtract + MUX (the
    compare-and-swap of sort_with_distance, src/KNN_medical_data.cpp:410-489)."""
    a_less = _bit(mk_subtract(ck, a, b, width), width - 1)
    lo = mk_mux_word(ck, a_less, a, b)
    hi = mk_mux_word(ck, a_less, b, a)
    return lo, hi


def mk_bubble_sort(ck: MKCloudKey, word_list, width: int, payloads=None):
    """Sort encrypted MK words ascending; optional payload word lists move
    with their keys (sort_with_distance, src/KNN_medical_data.cpp:410-489,
    over MK ciphertexts)."""
    word_list = list(word_list)
    payloads = [list(p) for p in payloads] if payloads is not None else None
    m = len(word_list)
    for i in range(m - 1):
        for j in range(m - 1 - i):
            a_less = _bit(mk_subtract(ck, word_list[j], word_list[j + 1],
                                      width), width - 1)
            lo = mk_mux_word(ck, a_less, word_list[j], word_list[j + 1])
            hi = mk_mux_word(ck, a_less, word_list[j + 1], word_list[j])
            word_list[j], word_list[j + 1] = lo, hi
            if payloads is not None:
                for p in payloads:
                    plo = mk_mux_word(ck, a_less, p[j], p[j + 1])
                    phi = mk_mux_word(ck, a_less, p[j + 1], p[j])
                    p[j], p[j + 1] = plo, phi
    return (word_list, payloads) if payloads is not None else word_list


def mk_conv2d(ck: MKCloudKey, image, kernels, zero: MKLweSample, stride: int,
              width: int) -> MKLweSample:
    """Encrypted integer conv2d (enc_conv2d, 3gen_mk_gates.jl:364-397).

    image: MKLweSample with axes (H, W, width, parties, n) per pixel word;
    kernels: (C, KH, KW, width, ...). Every (channel, out-pixel, kernel-tap)
    multiply is batched into one wide mk_int_mul (a single gate-bootstrap
    stream), then taps accumulate with ripple adds. Returns one MKLweSample
    with axes (C, OH, OW, width, parties, n).
    """
    H, W = image.a.shape[0], image.a.shape[1]
    C, KH, KW = kernels.a.shape[0], kernels.a.shape[1], kernels.a.shape[2]
    OH = (H - KH) // stride + 1
    OW = (W - KW) // stride + 1

    def tap(m, nn):
        # gather the (C, OH, OW) batch of image/kernel words for one tap;
        # word (bit) axis must lead for mk_int_mul, batch axes trail
        rows = [image.a[i * stride + m, j * stride + nn]
                for i in range(OH) for j in range(OW)]
        rows_b = [image.b[i * stride + m, j * stride + nn]
                  for i in range(OH) for j in range(OW)]
        px_a = jnp.broadcast_to(jnp.stack(rows)[None],
                                (C, OH * OW) + rows[0].shape)
        px_b = jnp.broadcast_to(jnp.stack(rows_b)[None],
                                (C, OH * OW) + rows_b[0].shape)
        kv_a = jnp.broadcast_to(kernels.a[:, m, nn][:, None],
                                (C, OH * OW) + rows[0].shape)
        kv_b = jnp.broadcast_to(kernels.b[:, m, nn][:, None],
                                (C, OH * OW) + rows_b[0].shape)
        # move the word axis (currently axis 2) to the front
        px = MKLweSample(jnp.moveaxis(px_a, 2, 0), jnp.moveaxis(px_b, 2, 0))
        kv = MKLweSample(jnp.moveaxis(kv_a, 2, 0), jnp.moveaxis(kv_b, 2, 0))
        return px, kv

    def widen(s: MKLweSample) -> MKLweSample:
        # an encrypted-0 BIT matching one bit of the batched word (the word
        # axis leads s, so a bit's shape is s.shape[1:])
        return MKLweSample(jnp.broadcast_to(zero.a, s.a.shape[1:]),
                           jnp.broadcast_to(zero.b, s.b.shape[1:]))

    acc = None
    for m in range(KH):
        for nn in range(KW):
            px, kv = tap(m, nn)
            prod = mk_int_mul(ck, px, kv, widen(px), width)
            acc = prod if acc is None else mk_add(ck, acc, prod,
                                                  widen(px), width)
    # (width, C, OH*OW, ...) -> (C, OH, OW, width, ...)
    a = jnp.moveaxis(acc.a, 0, 2).reshape(
        (C, OH, OW) + acc.a.shape[:1] + acc.a.shape[3:])
    b = jnp.moveaxis(acc.b, 0, 2).reshape(
        (C, OH, OW) + acc.b.shape[:1] + acc.b.shape[3:])
    return MKLweSample(a, b)
