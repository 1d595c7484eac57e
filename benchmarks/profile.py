"""Microbenchmark harness: encrypt/decrypt/gate/adder timings.

Counterpart of the reference's timing programs:
  * src/profile.cpp:10-87       — 100k-iteration LWE vs TLWE encrypt/decrypt
  * src/TlweProfile.cpp:11-26   — TLWE key allocation cost vs N
  * src/forCompare.cpp:136-300  — encrypt / XOR / HalfAdder / FullAdder timings

On the device the unit of work is a *batch*, so every row reports both wall time and
per-ciphertext amortised throughput. Run:

    python benchmarks/profile.py [--batch 4096] [--cpu] [--params test|128]

`--cpu` forces the host platform (fast sanity runs); default uses whatever
jax.devices() offers.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, *args, iters=3, warmup=1):
    """Wall time of fn(*args) with block_until_ready, after warmup."""
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--params", choices=["test", "128"], default="test")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from torus_fhe_tpu import lwe, rlwe
    from torus_fhe_tpu.boot import api, gates
    from torus_fhe_tpu.circuits import words
    from torus_fhe_tpu.core.params import test_parameters, tfhe_parameters_128

    params = test_parameters(n=16, N=64) if args.params == "test" else tfhe_parameters_128()
    B = args.batch
    rows = []

    def row(name, wall_s, count):
        rows.append((name, wall_s, count / wall_s))

    # --- keygen (TlweProfile.cpp: key setup cost) ---
    t0 = time.perf_counter()
    sk, ck = api.make_key_pair(jax.random.PRNGKey(0), params)
    jax.block_until_ready(ck.bootstrap_key.kernels)
    row("keygen(sk+bk+ksk)", time.perf_counter() - t0, 1)

    # --- LWE encrypt / decrypt (profile.cpp:34-60) ---
    msgs = jnp.asarray(np.random.default_rng(0).integers(0, 2, B) == 1)
    enc = jax.jit(lambda k: api.encrypt(k, sk, msgs))
    wall, ct = timed(enc, jax.random.PRNGKey(1), iters=args.iters)
    row(f"lwe_encrypt x{B}", wall, B)
    dec = jax.jit(lambda c: api.decrypt(sk, c))
    wall, _ = timed(dec, ct, iters=args.iters)
    row(f"lwe_decrypt x{B}", wall, B)

    # --- RLWE encrypt (profile.cpp TLWE side) ---
    N = params.rlwe_polynomial_degree
    rkey = rlwe.rlwe_keygen(jax.random.PRNGKey(2), params.rlwe)
    mu = jnp.zeros((B // 8 or 1, N), jnp.int32)
    # host-exact path (keygen-grade products) — not jittable by design
    renc = lambda k: rlwe.rlwe_encrypt(k, mu, 1e-7, rkey, params.rlwe,
                                       (B // 8 or 1,))
    wall, _ = timed(renc, jax.random.PRNGKey(3), iters=args.iters)
    row(f"rlwe_encrypt x{B // 8 or 1}", wall, B // 8 or 1)

    # --- single gates (forCompare.cpp XOR timing) ---
    ct2 = api.encrypt(jax.random.PRNGKey(4), sk, ~msgs)
    g = jax.jit(lambda x, y: gates.gate_xor(ck, x, y))
    wall, _ = timed(g, ct, ct2, iters=args.iters)
    row(f"gate_xor x{B}", wall, B)

    # --- half adder: sum=XOR carry=AND (forCompare.cpp:190-196) ---
    ha = jax.jit(lambda x, y: (gates.gate_xor(ck, x, y), gates.gate_and(ck, x, y)))
    wall, _ = timed(ha, ct, ct2, iters=args.iters)
    row(f"half_adder x{B}", wall, 2 * B)

    # --- full 8-bit ripple adder over a word batch (forCompare.cpp:289-300) ---
    W, BW = 8, max(B // 8, 1)
    vals = np.random.default_rng(1).integers(0, 200, (2, BW))
    wx = words.int_encrypt(jax.random.PRNGKey(5), sk, jnp.asarray(vals[0]), W)
    wy = words.int_encrypt(jax.random.PRNGKey(6), sk, jnp.asarray(vals[1]), W)
    zero = api.encrypt(jax.random.PRNGKey(7), sk, jnp.zeros(BW, bool))
    addf = jax.jit(lambda a, b, z: words.add(ck, a, b, z, W))
    wall, _ = timed(addf, wx, wy, zero, iters=max(args.iters // 2, 1))
    # 8 full adders x 5 gates each (2 XOR + 2 AND + 1 OR)
    row(f"adder8 x{BW}", wall, 5 * W * BW)

    dev = jax.devices()[0]
    print(f"# device={dev} params={args.params} batch={B}")
    print(f"{'operation':24s} {'wall_s':>10s} {'items/s':>14s}")
    for name, wall, thr in rows:
        print(f"{name:24s} {wall:10.4f} {thr:14.1f}")


if __name__ == "__main__":
    main()
