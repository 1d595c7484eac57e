"""Encrypted 2-D convolution (CNN layer) over single-key word ciphertexts.

Capability match for the reference's CNN workloads — CNN.jl / CNN_CPU.jl
(a CUDA conv3d over (H, W) inputs with `number_kernels` filters, stride and
valid padding; 3-gen-mk-tfhe/CNN.jl:9-48, 85-116) and the encrypted
`mk_conv2d` circuit (3gen_mk_gates.jl) — but batch-first and *stronger* than
CNN.jl itself: the input image is encrypted bit-sliced, and every
(filter, out_y, out_x) output word rides the trailing batch axes, so the
whole layer's ripple-carry adder network runs as ONE batched bootstrap
sequence rather than a thread per output pixel.

Layout: an encrypted image is one LweSample word with axes
(width_bits, H, W, ..., n) — the word layout of circuits/words.py with the
spatial dims as batch axes. Patch extraction, plaintext-weight multiplication
(shift-and-add), and negative weights (two's complement) are ciphertext
rearrangements and gate circuits; nothing is decrypted.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..boot.api import CloudKey
from ..boot import gates
from ..circuits import words
from ..lwe import LweSample


def shift_left(ck: CloudKey, word: LweSample, s: int, width: int) -> LweSample:
    """word << s within a fixed ``width``: prepend s trivial-zero bits, drop
    the top s bits. A free ciphertext rearrangement."""
    if s == 0:
        return word
    zero = gates.gate_constant(ck, jnp.zeros((s,) + word.b.shape[1:], bool))
    return LweSample(
        jnp.concatenate([zero.a, word.a[: width - s]], axis=0),
        jnp.concatenate([zero.b, word.b[: width - s]], axis=0),
    )


def scale_by_plaintext(ck: CloudKey, word: LweSample, c: int,
                       width: int) -> LweSample:
    """word * c for a plaintext integer c (mod 2^width), via shift-and-add.

    Negative c uses the two's-complement identity -x = ~x + 1 folded into the
    accumulation. Cost: popcount(|c|) - 1 word additions.
    """
    neg = c < 0
    c = -c if neg else c
    acc = None
    for s in range(width):
        if (c >> s) & 1:
            term = shift_left(ck, word, s, width)
            if acc is None:
                acc = term
            else:
                zero = gates.gate_constant(ck, jnp.zeros(acc.b.shape[1:], bool))
                acc = words.add(ck, acc, term, zero, width)
    if acc is None:  # c == 0: a width-bit zero word
        return gates.gate_constant(
            ck, jnp.zeros((width,) + word.b.shape[1:], bool))
    if neg:
        one = gates.gate_constant(ck, jnp.ones(acc.b.shape[1:], bool))
        acc = words.add(ck, words.ones_complement(ck, acc),
                        _stack_zero_word(ck, acc, width), one, width)
    return acc


def _stack_zero_word(ck: CloudKey, like: LweSample, width: int) -> LweSample:
    return gates.gate_constant(ck, jnp.zeros((width,) + like.b.shape[1:], bool))


def extract_patches(image: LweSample, kernel_size: int,
                    stride: int = 1) -> LweSample:
    """(width, H, W, ...) word image -> (width, kh*kw, oh, ow, ...) stacked
    patch words. Pure indexing — free on ciphertexts."""
    width, H, W = image.a.shape[0], image.a.shape[1], image.a.shape[2]
    oh = (H - kernel_size) // stride + 1
    ow = (W - kernel_size) // stride + 1

    def take(arr):
        pats = []
        for m in range(kernel_size):
            for nn in range(kernel_size):
                sl = arr[:, m:m + stride * oh:stride,
                         nn:nn + stride * ow:stride]
                pats.append(sl)
        return jnp.stack(pats, axis=1)  # (width, kh*kw, oh, ow, ...)

    return LweSample(take(image.a), take(image.b))


def conv2d(ck: CloudKey, image: LweSample, kernels: np.ndarray,
           width: int, stride: int = 1) -> LweSample:
    """Valid-padding encrypted conv2d with plaintext integer filters.

    image: word LweSample (width, H, W, ...); kernels: (F, kh, kw) ints.
    Returns a word LweSample (width, F, oh, ow, ...) — every filter and
    output position computed simultaneously on the batch axes (the CUDA
    thread grid of CNN.jl:14-16 becomes batch dims), so the adder network
    is shared: one gate sequence for the whole layer."""
    kernels = np.asarray(kernels)
    F, kh, kw = kernels.shape
    patches = extract_patches(image, kh, stride)  # (width, T, oh, ow, ...)
    T = kh * kw

    # Broadcast patches across filters: (width, F, T, oh, ow, ...)
    pa = jnp.broadcast_to(patches.a[:, None],
                          (width, F) + patches.a.shape[1:])
    pb = jnp.broadcast_to(patches.b[:, None],
                          (width, F) + patches.b.shape[1:])

    acc = None
    for t in range(T):
        tap = LweSample(pa[:, :, t], pb[:, :, t])  # (width, F, oh, ow, ...)
        # Per-filter weight for this tap: scale each filter's slice. Distinct
        # weights need distinct shift patterns, so loop filters but batch all
        # output positions per filter.
        terms_a, terms_b = [], []
        for f in range(F):
            w = int(kernels[f, t // kw, t % kw])
            fw = LweSample(tap.a[:, f], tap.b[:, f])
            term = scale_by_plaintext(ck, fw, w, width)
            terms_a.append(term.a)
            terms_b.append(term.b)
        term = LweSample(jnp.stack(terms_a, axis=1), jnp.stack(terms_b, axis=1))
        if acc is None:
            acc = term
        else:
            zero = gates.gate_constant(ck, jnp.zeros(term.b.shape[1:], bool))
            acc = words.add(ck, acc, term, zero, width)
    return acc  # (width, F, oh, ow, ...)


def extract_patches_3d(vol: LweSample, kernel_size: int,
                       stride: int = 1) -> LweSample:
    """(width, D, H, W, ...) word volume -> (width, kd*kh*kw, od, oh, ow, ...)
    stacked patch words. Pure indexing — free on ciphertexts."""
    width, D, H, W = (vol.a.shape[0], vol.a.shape[1], vol.a.shape[2],
                      vol.a.shape[3])
    k = kernel_size
    od = (D - k) // stride + 1
    oh = (H - k) // stride + 1
    ow = (W - k) // stride + 1

    def take(arr):
        pats = []
        for d in range(k):
            for m in range(k):
                for nn in range(k):
                    sl = arr[:, d:d + stride * od:stride,
                             m:m + stride * oh:stride,
                             nn:nn + stride * ow:stride]
                    pats.append(sl)
        return jnp.stack(pats, axis=1)

    return LweSample(take(vol.a), take(vol.b))


def conv3d(ck: CloudKey, vol: LweSample, kernels: np.ndarray,
           width: int, stride: int = 1) -> LweSample:
    """Valid-padding encrypted VOLUMETRIC conv3d with plaintext int filters.

    Note on naming: the reference's `conv3d` (3-gen-mk-tfhe/CNN.jl:9-48) is a
    2-D convolution launched on a 3-D CUDA grid whose z axis is the FILTER
    index — that workload is exactly `conv2d` here (its F axis is the batch
    twin of tidz). This function goes beyond it: a true 3-D convolution over
    (D, H, W) encrypted volumes with (F, kd, kh, kw) filters, same
    batched-adder design — every (filter, output-voxel) rides the batch axes.

    vol: word LweSample (width, D, H, W, ...); kernels: (F, k, k, k) ints.
    Returns (width, F, od, oh, ow, ...).
    """
    kernels = np.asarray(kernels)
    F, kd, kh, kw = kernels.shape
    assert kd == kh == kw, "cubic kernels"
    patches = extract_patches_3d(vol, kd, stride)  # (width, T, od, oh, ow, ..)
    T = kd * kh * kw

    pa = jnp.broadcast_to(patches.a[:, None],
                          (width, F) + patches.a.shape[1:])
    pb = jnp.broadcast_to(patches.b[:, None],
                          (width, F) + patches.b.shape[1:])

    acc = None
    for t in range(T):
        tap = LweSample(pa[:, :, t], pb[:, :, t])
        terms_a, terms_b = [], []
        for f in range(F):
            w = int(kernels[f, t // (kh * kw), (t // kw) % kh, t % kw])
            fw = LweSample(tap.a[:, f], tap.b[:, f])
            term = scale_by_plaintext(ck, fw, w, width)
            terms_a.append(term.a)
            terms_b.append(term.b)
        term = LweSample(jnp.stack(terms_a, axis=1),
                         jnp.stack(terms_b, axis=1))
        if acc is None:
            acc = term
        else:
            zero = gates.gate_constant(ck, jnp.zeros(term.b.shape[1:], bool))
            acc = words.add(ck, acc, term, zero, width)
    return acc  # (width, F, od, oh, ow, ...)


def conv3d_reference(vol: np.ndarray, kernels: np.ndarray,
                     stride: int = 1) -> np.ndarray:
    """Plaintext volumetric oracle for conv3d."""
    kernels = np.asarray(kernels)
    F, kd, kh, kw = kernels.shape
    D, H, W = vol.shape
    od = (D - kd) // stride + 1
    oh = (H - kh) // stride + 1
    ow = (W - kw) // stride + 1
    out = np.zeros((F, od, oh, ow), np.int64)
    for f in range(F):
        for d in range(od):
            for i in range(oh):
                for j in range(ow):
                    blk = vol[d * stride:d * stride + kd,
                              i * stride:i * stride + kh,
                              j * stride:j * stride + kw]
                    out[f, d, i, j] = int((blk * kernels[f]).sum())
    return out


def conv2d_reference(image: np.ndarray, kernels: np.ndarray,
                     stride: int = 1) -> np.ndarray:
    """Plaintext oracle matching conv3d's indexing (CNN.jl:19-35)."""
    kernels = np.asarray(kernels)
    F, kh, kw = kernels.shape
    H, W = image.shape
    oh = (H - kh) // stride + 1
    ow = (W - kw) // stride + 1
    out = np.zeros((F, oh, ow), np.int64)
    for f in range(F):
        for i in range(oh):
            for j in range(ow):
                out[f, i, j] = int(
                    (image[i * stride:i * stride + kh,
                           j * stride:j * stride + kw] * kernels[f]).sum())
    return out
