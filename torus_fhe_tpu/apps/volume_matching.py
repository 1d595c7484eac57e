"""Encrypted volume matching (dark-pool order matching) over multikey TFHE.

Rework of 3-gen-mk-tfhe/VolumeMatching.jl / VolMatch2.jl: buy and
sell order volumes arrive encrypted under the parties' multikey; the engine
computes the matched volume per order without decrypting anything:

  1. prefix sums of buy and sell volumes (sequential carry chains),
  2. total matched volume = min(Σbuy, Σsell),
  3. per order: matched_i = min(order_i, total − prefix_i).

The reference fans step 3 out over up to 106 Distributed.jl workers
(VolMatch2.jl:4, VolumeMatching.jl:108-176); here the order index is a batch
axis, so every order's subtract/compare/mux runs in ONE batched bootstrap
program — and shards over the mesh batch axis across cards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..mk import gates3gen as g
from ..mk.keys3gen import MKCloudKey
from ..mk.samples import MKLweSample


def _word(x: MKLweSample, i: int) -> MKLweSample:
    """Select order i from a word batch (width, m, ...)."""
    return MKLweSample(x.a[:, i], x.b[:, i])


def _stack_words(ws) -> MKLweSample:
    return MKLweSample(jnp.stack([w.a for w in ws], axis=1),
                       jnp.stack([w.b for w in ws], axis=1))


def prefix_sums(ck: MKCloudKey, orders: MKLweSample, zero: MKLweSample,
                width: int) -> MKLweSample:
    """Exclusive prefix sums over the order axis: out[i] = Σ_{j<i} orders[j]
    (the res_buy/res_sell accumulation, VolumeMatching.jl:42-78)."""
    m = orders.b.shape[1]
    zero_word = MKLweSample(jnp.broadcast_to(zero.a, orders.a[:, 0].shape),
                            jnp.broadcast_to(zero.b, orders.b[:, 0].shape))
    outs = [zero_word]
    acc = zero_word
    for i in range(m - 1):
        acc = g.mk_add(ck, acc, _word(orders, i), zero, width)
        outs.append(acc)
    return _stack_words(outs), g.mk_add(ck, acc, _word(orders, m - 1), zero, width)


def min_word(ck: MKCloudKey, a: MKLweSample, b: MKLweSample, one: MKLweSample,
             width: int) -> MKLweSample:
    """min(a, b) via greater + word MUX (VolumeMatching.jl:93-101)."""
    a_grt_b = g.mk_greater(ck, a, b, one, width)  # sign(b - a) = a > b
    sel = MKLweSample(jnp.broadcast_to(a_grt_b.a, a.a.shape),
                      jnp.broadcast_to(a_grt_b.b, a.b.shape))
    return g.mk_gate_mux(ck, sel, b, a)


def volume_match(ck: MKCloudKey, buys: MKLweSample, sells: MKLweSample,
                 zero: MKLweSample, one: MKLweSample, width: int):
    """Match encrypted buy volumes against sell volumes.

    buys/sells: (width, m, parties, n) MK word batches. Returns
    (matched_buys, matched_sells) of the same shapes.
    """
    buy_prefix, buy_total = prefix_sums(ck, buys, zero, width)
    sell_prefix, sell_total = prefix_sums(ck, sells, zero, width)

    total = min_word(ck, buy_total, sell_total, one, width)

    def matched(orders, prefix):
        m = orders.b.shape[1]
        tot = MKLweSample(jnp.broadcast_to(total.a[:, None], orders.a.shape),
                          jnp.broadcast_to(total.b[:, None], orders.b.shape))
        # per-order encrypted constant 1 (bit batch over the order axis)
        one_m = MKLweSample(jnp.broadcast_to(one.a, (m,) + one.a.shape),
                            jnp.broadcast_to(one.b, (m,)))
        # remaining_i = total − prefix_i, all orders in one batched circuit
        remaining = g.mk_sub(ck, tot, prefix, one_m, width)
        # matched_i = order_i <= remaining_i ? order_i : remaining_i — the
        # reference leaves orders beyond the total to the caller (they get the
        # (possibly negative) remainder, VolumeMatching.jl:116-125).
        leq = g.mk_leq(ck, orders, remaining, one_m, width)
        sel = MKLweSample(jnp.broadcast_to(leq.a, orders.a.shape),
                          jnp.broadcast_to(leq.b, orders.b.shape))
        return g.mk_gate_mux(ck, sel, orders, remaining)

    return matched(buys, buy_prefix), matched(sells, sell_prefix)
