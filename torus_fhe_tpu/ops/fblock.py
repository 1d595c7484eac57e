"""Block-circulant ("F-block") bootstrapping-key layout for GEMM blind rotation.

The negacyclic external product against a *fixed* kernel polynomial k is a
matmul by the N x N negacirculant matrix M[u, t] = ext[(t - u) mod 2N] with
ext = [k, -k].  Tiling M into bs x bs blocks, block (i, j) depends only on
delta = (j - i) mod (2N/bs): there are just D = 2N/bs distinct blocks per
kernel line.  Storing those D blocks per (row-poly r, kernel byte-limb
column) yields a bootstrapping-key layout where every CMux step is one
(B*nb, R*D*bs) @ (R*D*bs, ncols*bs) int8 GEMM with exact int32 accumulation
— no convolution lowering, no runtime circulant gathers of the key.

Kernel limb columns are *per output poly* (``geom.cols``): every mask poly
keeps all of its byte limbs; the body may drop its low ``drop_limbs`` bytes,
which keygen rounds to zero (boot/bootstrap.bootstrap_keygen), so the
product stays exact on the rounded key and the only noise added is that
rounding (~sigma_bk at one byte). At tfhe_128_tpu_fast that is 2 masks x 4
limbs + 3 body limbs = 11 columns.

This replaces the reference's per-gate f64 FFT externs
(3-gen-mk-tfhe/src/polynomials.jl:208-242, bootstrap.jl:19-45): per step the
key side streams once from device memory regardless of batch, so large
batches are bound by the int8 GEMM rather than by memory.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import poly


class FBlockGeometry(NamedTuple):
    n: int        # number of CMux steps (LWE size)
    N: int        # ring degree
    bs: int       # block size (min(128, N))
    nb: int       # N // bs
    D: int        # 2N // bs distinct deltas
    C: int        # k+1 polys per RLWE sample
    R: int        # l * C reduction rows
    cols: Tuple[Tuple[int, int], ...]  # kernel limb columns: (out_poly, shift)
    bits: int     # torus width


def default_cols(mask_size: int, bits: int, drop_limbs: int,
                 mask_quantum_bits: int = 0) -> Tuple[Tuple[int, int], ...]:
    """Kernel limb columns. Body (poly k) keeps limbs [drop_limbs:] — sound:
    the body is ROUNDED at keygen so the dropped bytes are exactly zero and
    the rounding is ordinary post-hoc noise on a full-entropy sample. Mask
    polys ALWAYS keep every limb unless ``mask_quantum_bits`` is set.

    SECURITY WARNING (r5): quantized-mask keys (mask_quantum_bits > 0) are
    BROKEN when the encryption noise is below the mask grid — rounding each
    published body to the grid cancels the noise exactly and the secret key
    falls to linear algebra mod 2 (demonstrated end-to-end in
    tests/test_quantized_mask_attack.py: full key recovery from TWO
    published BK samples). No shipped parameter set uses it; the knob
    remains only so the attack test can construct a vulnerable key."""
    nl = poly.n_limbs_for(bits)
    mask_start = (mask_quantum_bits // 8) if mask_quantum_bits else 0
    cols = []
    for j in range(mask_size):
        cols += [(j, 8 * m) for m in range(mask_start, nl)]
    cols += [(mask_size, 8 * m) for m in range(drop_limbs, nl)]
    return tuple(cols)


def fblock_geometry(n: int, N: int, mask_size: int, decomp_length: int,
                    bits: int, drop_limbs: int, block: int = 128,
                    mask_quantum_bits: int = 0) -> FBlockGeometry:
    bs = min(block, N)
    assert N % bs == 0
    C = mask_size + 1
    return FBlockGeometry(
        n=n, N=N, bs=bs, nb=N // bs, D=2 * N // bs, C=C,
        R=decomp_length * C,
        cols=default_cols(mask_size, bits, drop_limbs, mask_quantum_bits),
        bits=bits)


def _delta_index(geom: FBlockGeometry) -> np.ndarray:
    """(D, bs, bs) gather index: idx[delta, p, q] = (bs*delta + q - p) mod 2N."""
    d = np.arange(geom.D)[:, None, None]
    p = np.arange(geom.bs)[None, :, None]
    q = np.arange(geom.bs)[None, None, :]
    return ((geom.bs * d + q - p) % (2 * geom.N)).astype(np.int32)


def seq_perm(D: int) -> np.ndarray:
    """Reverse-cyclic delta ordering: seq[m] = delta-block[(-m) mod D].

    In this order, the kernel rows needed for output block j — blocks
    delta=(j-i) mod D for digit blocks i = 0..nb-1 — sit at consecutive
    positions m = (i-j) mod D, so each output block's contraction is one or
    two *contiguous* long-K matmuls instead of nb short ones (the GEMM's
    own accumulation replaces nb-1 elementwise adds per block).
    """
    return (-np.arange(D)) % D


def build_sel(samples: np.ndarray, geom: FBlockGeometry) -> np.ndarray:
    """The COMPACT F-block form: per CMux step, the extended (negated-wrap)
    kernel lines split into the kept byte-limb columns.

    samples: (n, l, C, C, N) torus ints (host numpy). Returns
    (n, R, 2N, ncols) int8 — ~256x smaller than the expanded key; every
    bs x bs delta block of the expanded key is a shifted window of these
    lines, so the expansion can be (re)materialised on-device at will
    (build_fblocks ahead of time, or expand_fblock_chunk streamed per
    step-chunk when the expanded key exceeds HBM).
    """
    n, l, C, C2, N = samples.shape
    assert (C, N, l * C) == (geom.C, geom.N, geom.R) and C == C2
    kern = np.ascontiguousarray(samples.reshape(n, geom.R, C, N))
    with np.errstate(over="ignore"):
        ext = np.concatenate([kern, -kern], axis=-1)  # wraps mod 2^bits
    limbs = poly.limb_split_signed_host(ext, geom.bits)  # (n, R, C, 2N, nl)
    # select the kept (poly, limb) columns -> (n, R, 2N, ncols)
    sel = np.stack([limbs[:, :, p, :, s // 8] for p, s in geom.cols], axis=-1)
    return np.ascontiguousarray(sel)


def expand_fblock_chunk(sel_chunk, geom: FBlockGeometry) -> jax.Array:
    """Expand compact kernel lines into the F-block layout ON DEVICE,
    jit-compatible (the streamed-key path's inner expansion).

    sel_chunk: (cs, R, 2N, ncols) int8. Returns (cs, D*R*bs, ncols*bs) int8
    in seq_perm delta order — bit-identical to the matching slice of
    build_fblocks. The expansion is bs static rolls of the line axis (block
    row p of every delta block is the line rolled by p), i.e. pure
    slice/concat/transpose, no gather.
    """
    cs, R, twoN, ncols = sel_chunk.shape
    D, bs = geom.D, geom.bs
    assert (R, twoN) == (geom.R, 2 * geom.N) and ncols == len(geom.cols)
    perm = seq_perm(D)
    rows = []
    for p in range(bs):
        # roll(line, p)[f] = line[(f - p) mod 2N]; W[m, p, q] =
        # line[(bs*perm[m] + q - p) mod 2N]
        r = jnp.roll(sel_chunk, p, axis=2)
        r = r.reshape(cs, R, D, bs, ncols)[:, :, perm]  # (cs, R, m, q, ncols)
        rows.append(r)
    g = jnp.stack(rows, axis=3)  # (cs, R, m, p, q, ncols)
    g = g.transpose(0, 2, 1, 3, 5, 4)  # (cs, m, R, p, ncols, q)
    return g.reshape(cs, D * R * bs, ncols * bs)


def build_fblocks(samples: np.ndarray, geom: FBlockGeometry,
                  chunk: int = 64) -> jax.Array:
    """Build the F-block key from raw TGSW samples.

    samples: (n, l, C, C, N) torus ints (host numpy); samples[s, i, j, c] is
    output-poly c of RLWE row (digit-level i, poly j) of step s's TGSW sample
    (matching tgsw.TGswSample layout).  Returns (n, D*R*bs, ncols*bs) int8 on
    the default device, with delta blocks in ``seq_perm`` order along the row
    axis; the gather/transpose runs on-device in step chunks so only the
    compact ext-limb tensor crosses the transfer boundary.
    """
    n = samples.shape[0]
    sel = build_sel(samples, geom)
    ncols = len(geom.cols)

    perm = seq_perm(geom.D)

    if jax.default_backend() == "cpu":
        # host fast path: windowed strided view + one gather of exactly the
        # output size (no D*bs^2 index materialisation, ~10x faster)
        selp = np.concatenate([sel, sel[:, :, :geom.bs]], axis=2)
        W = np.lib.stride_tricks.sliding_window_view(selp, geom.bs, axis=2)
        # W: (n, R, 2N+1, ncols, bs); starts[m, p] = (bs*perm[m] - p) % 2N
        starts = ((geom.bs * perm[:, None]
                   - np.arange(geom.bs)[None, :]) % (2 * geom.N))
        g = W[:, :, starts]  # (n, R, m, p, ncols, q)
        g = np.ascontiguousarray(g.transpose(0, 2, 1, 3, 4, 5))
        return jnp.asarray(g.reshape(n, geom.D * geom.R * geom.bs,
                                     ncols * geom.bs))

    idx = jnp.asarray(_delta_index(geom)[perm].reshape(-1))

    @jax.jit
    def _expand(lchunk):
        # lchunk: (cs, R, 2N, ncols) int8
        g = jnp.take(lchunk, idx, axis=-2)  # (cs, R, D*bs*bs, ncols)
        cs = lchunk.shape[0]
        g = g.reshape(cs, geom.R, geom.D, geom.bs, geom.bs, ncols)
        g = g.transpose(0, 2, 1, 3, 5, 4)  # (cs, m, R, p, ncols, q)
        return g.reshape(cs, geom.D * geom.R * geom.bs, ncols * geom.bs)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def _write(fb, block, start):
        zero = jnp.zeros((), start.dtype)
        return lax.dynamic_update_slice(fb, block, (start, zero, zero))

    fb = jnp.zeros((n, geom.D * geom.R * geom.bs, ncols * geom.bs), jnp.int8)
    for s0 in range(0, n, chunk):
        s1 = min(s0 + chunk, n)
        fb = _write(fb, _expand(jnp.asarray(sel[s0:s1])), jnp.int32(s0))
    return fb


def contract_rows_fblock(d8, fstep, geom: FBlockGeometry, dtype=jnp.int32):
    """Contract int8 digit rows against ONE expanded F-block step.

    d8: (B, R, N) int8 rows (row r = digit level x poly, the TGsw order);
    fstep: (D*R*bs, ncols*bs) int8 in seq_perm order. Returns (B, C, N):
    out[c] = sum_r rows_r (*) K_{r,c}, the negacyclic products realised as
    one block-circulant int8 GEMM with exact int32 accumulation.
    """
    B = d8.shape[0]
    nb, D, bs, R, C = geom.nb, geom.D, geom.bs, geom.R, geom.C
    ncols = len(geom.cols)
    perm = jnp.asarray(seq_perm(D))  # seq[m] = block[(-m)%D] (involution)
    # dexp gather plan: for output block j, contraction block delta pulls
    # digit block i = (j - delta) mod D, valid only when i < nb.
    ji = (np.arange(nb)[:, None] - np.arange(D)[None, :]) % D  # (j, delta)
    valid = ji < nb
    ji_safe = np.where(valid, ji, 0)

    d8 = d8.reshape(B, R, nb, bs)
    g = d8[:, :, ji_safe, :]  # (B, R, j, delta, bs)
    g = jnp.where(valid[None, None, :, :, None], g, 0)
    dexp = jnp.moveaxis(g, 2, 1).reshape(B * nb, R * D * bs)
    fmat = fstep.reshape(D, R, bs, -1)[perm]  # back to delta order
    fmat = jnp.moveaxis(fmat, 0, 1).reshape(R * D * bs, -1)
    prod = jnp.dot(dexp, fmat, preferred_element_type=jnp.int32)
    prod = prod.reshape(B, nb, ncols, bs)
    comb = jnp.zeros((B, nb, C, bs), dtype)
    for ci, (p, shift) in enumerate(geom.cols):
        comb = comb.at[:, :, p].add(prod[:, :, ci].astype(dtype) << shift)
    return jnp.moveaxis(comb, 1, 2).reshape(B, C, geom.N)


def apply_fblock(t, fstep, geom: FBlockGeometry, decomp_length: int,
                 log2_base: int, offset: int):
    """delta[c] = sum_r g(t)_r (*) K_{r,c}: gadget-decompose a (B, C, N)
    input jointly and contract against one expanded F-block step. Digits
    wider than a byte split into int8 blocks whose outputs shift-combine
    (poly.digits_to_i8_rows) — the same split as the conv backend."""
    B, C, N = t.shape
    digits = poly.decompose(t, decomp_length, log2_base, geom.bits, offset)
    digits = jnp.swapaxes(digits, -3, -2)  # (B, l, C, N): rows r = (i, j)
    blocks = poly.digits_to_i8_rows(digits.reshape(B, 1, geom.R, N), log2_base)
    total = None
    for m, blk in enumerate(blocks):
        delta = contract_rows_fblock(blk.reshape(B, geom.R, N), fstep, geom,
                                     t.dtype)
        if m:
            delta = delta << (8 * m)
        total = delta if total is None else total + delta
    return total


def blind_rotate_fblock(acc_a, fb, bara, geom: FBlockGeometry,
                        decomp_length: int, log2_base: int, offset: int):
    """XLA scan over the CMux chain using the F-block key.

    acc_a: (B, C, N) torus; fb: (n, D*R*bs, ncols*bs) int8 in seq_perm order;
    bara: (B, n). Exact per-step semantics identical to bootstrap.mux_rotate
    on the same (body-rounded) key.
    """
    # digits wider than a byte split into shift-combined int8 blocks inside
    # apply_fblock — no base restriction

    def step(acc, xs):
        fstep, bara_s = xs  # (D*R*bs, ncols*bs), (B,)
        rot = poly.mul_by_monomial(acc, bara_s)
        delta_t = apply_fblock(rot - acc, fstep, geom, decomp_length,
                               log2_base, offset)
        return acc + delta_t, None

    acc, _ = lax.scan(step, acc_a, (fb, jnp.swapaxes(jnp.asarray(bara), 0, 1)))
    return acc


def blind_rotate_streamed(acc_a, sel, bara, geom: FBlockGeometry,
                          decomp_length: int, log2_base: int, offset: int,
                          *, chunk: int = 64):
    """Blind rotate against the COMPACT key, expanding F-blocks on the fly in
    step chunks — the large-party multikey answer: an 8-party production
    F-block key is ~72 GB expanded (parallel/mk_pipeline.py) but ~0.6 GB
    compact, and the expansion is bandwidth-optimal rolls, so one chip runs
    the fast path at ~2x the HBM traffic of the (impossible-to-fit)
    pre-expanded key. Replaces the reference's sequential party loop
    (3-gen-mk-tfhe/src/3gen_mk_internals.jl:66-95) at any party count.

    sel: (steps, R, 2N, ncols) int8 (build_sel); bara: (B, steps) int32;
    acc_a: (B, C, N) torus. Bit-identical to blind_rotate_fblock on the same
    key (pad steps are exact identities: bara=0 and zero kernel digits).
    """
    steps = sel.shape[0]
    B = bara.shape[0]
    spad = (-steps) % chunk
    if spad:
        sel = jnp.concatenate(
            [sel, jnp.zeros((spad,) + sel.shape[1:], sel.dtype)], axis=0)
        bara = jnp.concatenate(
            [bara, jnp.zeros((B, spad), bara.dtype)], axis=1)
    geom_c = geom._replace(n=chunk)
    n_chunks = (steps + spad) // chunk
    sel_c = sel.reshape((n_chunks, chunk) + sel.shape[1:])
    bara_c = jnp.swapaxes(bara.reshape(B, n_chunks, chunk), 0, 1)

    # ONE outer lax.scan over chunks: the chunk body (expansion + rotate)
    # compiles once instead of once per chunk — a python chunk loop at
    # production step counts produced programs that took an hour to compile
    def body(acc, xs):
        sel_k, bara_k = xs
        fb_k = expand_fblock_chunk(sel_k, geom)
        acc = blind_rotate_fblock(acc, fb_k, bara_k, geom_c,
                                  decomp_length, log2_base, offset)
        return acc, None

    acc, _ = lax.scan(body, acc_a, (sel_c, bara_c))
    return acc
