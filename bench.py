"""Benchmark: decrypt-checked bootsAND gate bootstraps per second on one GPU.

    python bench.py [batch] [--l3] [--fresh-key]

Runs gate_and at tfhe_128_tpu_fast (``--l3``: tfhe_128_tpu) on the F-block
key, checks every output bit against plaintext, then times the dispatched
batches, a chain of 8 NANDs inside one program, and a batch of one. Prints
exactly one JSON line naming the device it ran on. Exits non-zero without a
GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def main() -> None:
    from torus_fhe_tpu.boot import api, gates
    from torus_fhe_tpu.core.params import (tfhe_parameters_128_tpu,
                                           tfhe_parameters_128_tpu_fast)
    from torus_fhe_tpu.utils import serialize
    from torus_fhe_tpu.utils.device import REPO_ROOT, configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU, JAX found {dev.platform!r}")

    def log(msg):
        print(f"[bench +{time.time() - T0:8.1f}s] {msg}", file=sys.stderr,
              flush=True)

    T0 = time.time()
    l3 = "--l3" in sys.argv
    params = tfhe_parameters_128_tpu() if l3 else tfhe_parameters_128_tpu_fast()
    t0 = time.time()
    # Keys round-trip through the compact serialized form (utils/serialize):
    # runs after the first skip the TGSW keygen.
    key_dir = os.path.join(REPO_ROOT, ".cache", "keys")
    os.makedirs(key_dir, exist_ok=True)
    tag = "l3" if l3 else "fast"
    sk_path = os.path.join(key_dir, f"bench_sk_{tag}.npz")
    ck_path = os.path.join(key_dir, f"bench_ck_{tag}.npz")
    sk = None
    if (os.path.exists(sk_path) and os.path.exists(ck_path)
            and "--fresh-key" not in sys.argv):
        log("loading cached key")
        sk = serialize.load_secret_key(sk_path)
        if sk.params != params:  # stale cache from an older parameter rev
            log("cached key params stale; regenerating")
            sk = None
        else:
            ck = serialize.load_cloud_key(ck_path, forms=("fblock",))
    if sk is None:
        log("keygen start")
        sk, ck = api.make_key_pair(jax.random.PRNGKey(0), params,
                                   forms=("fblock",))
        serialize.save_secret_key(sk_path, sk)
        serialize.save_cloud_key(ck_path, ck)
    jax.block_until_ready(ck.bootstrap_key.fb)
    keygen_s = time.time() - t0
    log(f"key ready ({keygen_s:.1f}s)")

    pos = [a for a in sys.argv[1:] if not a.startswith("-")]
    B = int(pos[0]) if pos else 4096
    rng = np.random.default_rng(42)
    xs = jnp.asarray(rng.integers(0, 2, B, dtype=np.int64) == 1)
    ys = jnp.asarray(rng.integers(0, 2, B, dtype=np.int64) == 1)
    cx = api.encrypt(jax.random.PRNGKey(1), sk, xs)
    cy = api.encrypt(jax.random.PRNGKey(2), sk, ys)

    step = jax.jit(gates.gate_and)

    log("gate compile start")
    t0 = time.time()
    out = step(ck, cx, cy)
    out.b.block_until_ready()
    compile_s = time.time() - t0
    log(f"gate compile done ({compile_s:.1f}s)")

    # correctness gate: don't benchmark garbage
    dec = np.asarray(api.decrypt(sk, out))
    want = np.asarray(xs) & np.asarray(ys)
    assert np.array_equal(dec, want), "bootsAND decrypt mismatch"
    log("correctness gate passed; timing")

    # timed region (host-dispatched batches)
    iters = 4
    t0 = time.time()
    for _ in range(iters):
        out = step(ck, cx, cy)
    out.b.block_until_ready()
    dt = time.time() - t0

    # steady-state: T chained NANDs inside ONE program (x_{t+1} = NAND(x_t, y)
    # — a real sequential circuit), free of per-batch host dispatch.
    # Decrypt-checked against the plaintext recurrence below.
    T = 8

    def chain(ck, x0, y):
        def body(x, _):
            return gates.gate_nand(ck, x, y), None

        xT, _ = jax.lax.scan(body, x0, None, length=T)
        return xT

    chain_j = jax.jit(chain)
    log("chain compile start")
    outc = chain_j(ck, cx, cy)
    outc.b.block_until_ready()
    log("chain compiled; timing")
    t0 = time.time()
    outc = chain_j(ck, cx, cy)
    outc.b.block_until_ready()
    dt_chain = time.time() - t0
    px = np.asarray(xs)
    for _ in range(T):
        px = ~(px & np.asarray(ys))
    assert np.array_equal(np.asarray(api.decrypt(sk, outc)), px), \
        "chained NAND decrypt mismatch"
    chain_rate = B * T / dt_chain

    # secondary metric: single-bootstrap p50 latency (batch of 1)
    c1 = api.encrypt(jax.random.PRNGKey(3), sk, jnp.asarray([True]))
    lat = step(ck, c1, c1)  # compile the B=1 shape
    lat.b.block_until_ready()
    lats = []
    for _ in range(5):
        t1 = time.time()
        lat = step(ck, c1, c1)
        lat.b.block_until_ready()
        lats.append(time.time() - t1)
    p50_ms = sorted(lats)[len(lats) // 2] * 1e3

    gates_per_s = B * iters / dt
    print(json.dumps({
        "metric": "bootsAND_gates_per_sec",
        "value": round(chain_rate, 2),
        "unit": "gates/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": {
            "regime": "chained_steady_state",
            "dispatched_gates_per_s": round(gates_per_s, 2),
            "chained_gates_per_s": round(chain_rate, 2),
            "chain_len": T,
            "batch": B, "iters": iters, "wall_s": round(dt, 3),
            "compile_s": round(compile_s, 2), "keygen_s": round(keygen_s, 2),
            "p50_single_bootstrap_ms": round(p50_ms, 1),
            "params": ("tfhe_128_tpu (n=630, N=1024, k=1, l=3 Bg=2^7, "
                       "full masks + body-2^8 rounding, 7 limb-cols)"
                       if l3 else
                       "tfhe_128_tpu_fast (n=630, N=512, k=2 module-LWE, "
                       "l=2 Bg=2^8, full masks + body-2^8 rounding, "
                       "11 limb-cols)"),
            "backend": "F-block GEMM scan (XLA)",
        },
    }))


if __name__ == "__main__":
    main()
