"""Multi-chip scaling benchmark: gates/s vs device count over a batch mesh.

The BASELINE scaling row ("gates/s efficiency measured at 1 chip, 1 host,
>=2 hosts") — and the mesh answer to the reference's Distributed.jl
fan-out (3-gen-mk-tfhe/VolMatch2.jl:4: addprocs(106) + @spawnat over order
batches). Here the "workers" are mesh slices: the bootstrapping/keyswitch
keys are replicated on every chip, the gate batch is sharded along the
`batch` mesh axis, and XLA runs the blind rotates fully in parallel — no
collectives on the hot path at all (data parallelism over independent
ciphertexts; the only cross-chip traffic is the initial shard placement).

Per device count d it reports gates/s, per-device gates/s, and parallel
efficiency vs the single-device run. Every timed batch is decrypt-checked
first (same rule as bench.py).

Usage:
    python benchmarks/scaling.py                      # real devices (GPU)
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py --platform cpu   # virtual 8-CPU mesh
                                                      # (functional numbers)
Writes measurements/scaling_<platform>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_mk_mid(jax):
    """4-party pipelined MK bootstrap at n=64/N=512 on a 4-slice party mesh:
    mid-size per-shard key volume (vs the n=6/N=64 unit tests), decrypt-
    checked, with per-shard key bytes and wall time reported."""
    jax.config.update("jax_enable_x64", True)  # 64-bit MK keygen
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from torus_fhe_tpu import mk
    from torus_fhe_tpu.core.params import test_parameters_3gen
    from torus_fhe_tpu.mk import gates3gen
    from torus_fhe_tpu.mk.samples import mk_decrypt, mk_encrypt
    from torus_fhe_tpu.parallel import mk_pipeline
    from torus_fhe_tpu.parallel.mesh import PARTY_AXIS

    parties = 4
    params = test_parameters_3gen(parties=parties, n=64, N=512)
    sks = [mk.mk_party_keygen(jax.random.PRNGKey(100 + p), params)
           for p in range(parties)]
    ck = mk.mk_cloud_keygen(jax.random.PRNGKey(7), sks, params,
                            forms=("fblock",), keep_samples=True)
    lwe_keys = [s.lwe for s in sks]
    mesh = Mesh(np.array(jax.devices()[:parties]), (PARTY_AXIS,))
    t0 = time.time()
    fb_sh = mk_pipeline.build_sharded_mk_fb(ck.bk_samples, params, parties,
                                            mesh)
    build_s = time.time() - t0
    shard_bytes = fb_sh.dtype.itemsize * int(
        np.prod(fb_sh.shape[1:])) * 1  # one party slice per device
    msgs = jnp.asarray(np.random.default_rng(3).integers(0, 2, 8) == 1)
    ct = mk_encrypt(jax.random.PRNGKey(8), lwe_keys, msgs, params)
    tct = mk_encrypt(jax.random.PRNGKey(9), lwe_keys,
                     jnp.ones(msgs.shape, bool), params)
    t = gates3gen.mk_gate_and_wb(ck, ct, tct)
    t0 = time.time()
    out = mk_pipeline.mk_bootstrap_pipelined(ck, fb_sh, gates3gen._mu(ck), t,
                                             mesh, microbatches=4)
    out.b.block_until_ready()
    wall = time.time() - t0
    ok = bool(np.array_equal(np.asarray(mk_decrypt(lwe_keys, out)),
                             np.asarray(msgs)))
    assert ok, "mk pipeline decrypt mismatch at mid size"
    return {"parties": parties, "n": 64, "N": 512, "batch": int(msgs.size),
            "per_shard_key_bytes": shard_bytes,
            "build_s": round(build_s, 2), "bootstrap_wall_s": round(wall, 2),
            "correct": ok}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device-batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--params", default=None,
                    help="registry name (default: tfhe_128_tpu_fast, "
                         "tfhe_test_small on cpu)")
    ap.add_argument("--counts", default=None,
                    help="comma-separated device counts (default 1,2,4,..,D)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mk-mid", action="store_true",
                    help="also run the 4-party pipelined MK bootstrap at a "
                         "mid-size config (n=64, N=512) on the mesh to "
                         "exercise real per-shard key volume (VERDICT r3 #7)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from torus_fhe_tpu.boot import api, gates
    from torus_fhe_tpu.core.params import PARAMETER_REGISTRY
    from torus_fhe_tpu.parallel import mesh as pmesh

    platform = jax.devices()[0].platform
    pname = args.params or ("tfhe_test_small" if platform == "cpu" else
                            "tfhe_128_tpu_fast")
    params = PARAMETER_REGISTRY[pname]()

    D = len(jax.devices())
    if args.counts:
        counts = [int(c) for c in args.counts.split(",")]
    else:
        counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= D]

    t0 = time.time()
    sk, ck0 = api.make_key_pair(jax.random.PRNGKey(0), params,
                                forms=("fblock",))
    print(f"keygen({pname}) {time.time() - t0:.1f}s on {platform} x{D}",
          file=sys.stderr, flush=True)

    results = []
    base_rate = None
    for d in counts:
        devices = jax.devices()[:d]
        m = pmesh.make_mesh(n_batch=d, n_party=1, devices=devices)
        ck = pmesh.replicate_cloud_key(ck0, m)
        B = args.per_device_batch * d
        rng = np.random.default_rng(7)
        xs = rng.integers(0, 2, B, dtype=np.int64) == 1
        ys = rng.integers(0, 2, B, dtype=np.int64) == 1
        cx = pmesh.shard_lwe_batch(
            api.encrypt(jax.random.PRNGKey(1), sk, jnp.asarray(xs)), m)
        cy = pmesh.shard_lwe_batch(
            api.encrypt(jax.random.PRNGKey(2), sk, jnp.asarray(ys)), m)

        step = jax.jit(gates.gate_and, out_shardings=pmesh.batch_sharding(m))
        t0 = time.time()
        out = step(ck, cx, cy)
        out.b.block_until_ready()
        compile_s = time.time() - t0

        # correctness gate on every lane before timing
        from torus_fhe_tpu.lwe import LweSample

        host = LweSample(np.asarray(jax.device_get(out.a)),
                         np.asarray(jax.device_get(out.b)))
        dec = np.asarray(api.decrypt(sk, host))
        assert np.array_equal(dec, xs & ys), f"decrypt mismatch at d={d}"

        t0 = time.time()
        for _ in range(args.iters):
            out = step(ck, cx, cy)
        out.b.block_until_ready()
        dt = time.time() - t0
        rate = B * args.iters / dt

        # device-only time via a profiler trace of ONE step (VERDICT r3
        # item 7): separates sharded-program compute from host dispatch /
        # virtual-device emulation contention. total_device_us sums over all
        # device lanes, so /d is the average per-device busy time.
        device_busy_s = None
        try:
            import shutil
            import tempfile

            from torus_fhe_tpu.utils import profiling

            tdir = tempfile.mkdtemp(prefix=f"scaling_trace_{d}_")
            with profiling.device_trace(tdir):
                out = step(ck, cx, cy)
                out.b.block_until_ready()
            device_busy_s = profiling.summarize_trace(
                tdir)["total_device_us"] / 1e6
            shutil.rmtree(tdir, ignore_errors=True)
        except Exception as e:  # tracing unsupported -> wall numbers only
            print(f"# trace failed at d={d}: {str(e)[:120]}", file=sys.stderr)

        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * d / counts[0])
        row = {"devices": d, "batch": B, "gates_per_s": round(rate, 1),
               "gates_per_s_per_device": round(rate / d, 1),
               "efficiency": round(eff, 4), "compile_s": round(compile_s, 2),
               "wall_s": round(dt, 3),
               "wall_s_per_iter": round(dt / args.iters, 3)}
        if device_busy_s is not None:
            row["device_busy_s_per_iter"] = round(device_busy_s, 3)
            row["device_busy_s_per_device"] = round(device_busy_s / d, 3)
            row["host_overhead_s_per_iter"] = round(
                max(0.0, dt / args.iters - device_busy_s / d), 3)
        results.append(row)
        print(json.dumps(row), flush=True)

    mk_mid = None
    if args.mk_mid:
        mk_mid = run_mk_mid(jax)
        print(json.dumps({"mk_pipeline_mid": mk_mid}), flush=True)

    payload = {"platform": platform, "params": pname,
               "per_device_batch": args.per_device_batch,
               "iters": args.iters, "device": str(jax.devices()[0]),
               "results": results}
    if mk_mid is not None:
        payload["mk_pipeline_mid"] = mk_mid
    if platform == "cpu":
        payload["note"] = (
            "virtual host devices share one physical CPU: wall-clock "
            "efficiency mostly measures emulation contention (all shards "
            "compete for the same cores), which is why it decays with d. "
            "On this backend the trace-measured busy columns are CORE-seconds "
            "of the shared XLA:CPU Eigen pool (they can exceed wall time): "
            "busy growing ~linearly with d while wall grows too is exactly "
            "the contention signature — per-shard WORK stays constant, the "
            "cores saturate. At high d the Eigen pool's spin-waiting "
            "inflates busy beyond physically available core-seconds, so "
            "treat large-d busy values as an upper bound. On real chips "
            "each shard runs on its own silicon, so per-device busy time, "
            "not this wall-clock efficiency, is the scaling predictor")
    out_path = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "measurements", f"scaling_{platform}.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
