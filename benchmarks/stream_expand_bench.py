"""Microbenchmark: where does the streamed MK rotate spend its time?

Times, on the real device at a given party count's registry set:
  (a) expand_fblock_chunk alone (the per-chunk roll expansion),
  (b) blind_rotate_fblock on a pre-expanded chunk (the GEMM core),
  (c) the fused blind_rotate_streamed (expansion + rotate),
so the expansion overhead of the streamed path is measured, not guessed —
the input to any work on expanding the key inside the rotate.

    python benchmarks/stream_expand_bench.py [--parties 4] [--batch 512]
        [--chunk 64] [--cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parties", type=int, default=4)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from torus_fhe_tpu.utils.device import configure_compile_cache

    configure_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from torus_fhe_tpu import mk
    from torus_fhe_tpu.core.params import (PARAMETER_REGISTRY,
                                           TGswParams, test_parameters_3gen)
    from torus_fhe_tpu.mk.keys3gen import mk_fb_geometry
    from torus_fhe_tpu.ops import fblock

    params = (test_parameters_3gen(parties=args.parties, n=32, N=128)
              if args.tiny else
              PARAMETER_REGISTRY[f"mk_{args.parties}party_3gen"]())
    P = args.parties
    print(f"# keygen {P}-party ...", file=sys.stderr, flush=True)
    sks = [mk.mk_party_keygen(jax.random.PRNGKey(100 + p), params)
           for p in range(P)]
    ck = mk.mk_cloud_keygen(jax.random.PRNGKey(7), sks, params,
                            forms=("fbstream",))
    geom = mk_fb_geometry(params, P)
    tg32 = TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 32)
    steps = P * params.lwe_size
    B, C = args.batch, geom.C
    rng = np.random.default_rng(0)
    bara = jnp.asarray(rng.integers(0, 2 * geom.N, (B, steps),
                                    dtype=np.int64), jnp.int32)
    sel = ck.bk_fb_sel

    def timeit(fn, *a, iters=3, **kw):
        out = jax.block_until_ready(fn(*a, **kw))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = jax.block_until_ready(fn(*a, **kw))
        return (time.perf_counter() - t0) / iters, out

    with jax.enable_x64(False):
        # (a) expansion alone, whole key in chunks
        exp_j = jax.jit(lambda s: fblock.expand_fblock_chunk(s, geom))
        t_exp1, fb_c = timeit(exp_j, sel[:args.chunk])
        n_chunks = (steps + args.chunk - 1) // args.chunk
        t_expand_total = t_exp1 * n_chunks

        # (b) rotate on the pre-expanded chunk
        geom_c = geom._replace(n=args.chunk)
        acc0 = jnp.zeros((B, C, geom.N), jnp.int32).at[:, C - 1].set(1 << 29)
        rot_j = jax.jit(lambda f, ba: fblock.blind_rotate_fblock(
            acc0, f, ba, geom_c, tg32.decomp_length, tg32.log2_base,
            tg32.offset))
        t_rot1, _ = timeit(rot_j, fb_c, bara[:, :args.chunk])
        t_rotate_total = t_rot1 * n_chunks

        # (c) fused streamed rotate over the full chain
        str_j = jax.jit(lambda s, ba: fblock.blind_rotate_streamed(
            acc0, s, ba, geom, tg32.decomp_length, tg32.log2_base,
            tg32.offset, chunk=args.chunk))
        t_stream, _ = timeit(str_j, sel, bara, iters=2)

    import json

    print(json.dumps({
        "parties": P, "batch": B, "chunk": args.chunk, "steps": steps,
        "expand_per_chunk_s": round(t_exp1, 4),
        "rotate_per_chunk_s": round(t_rot1, 4),
        "expand_total_s": round(t_expand_total, 3),
        "rotate_total_s": round(t_rotate_total, 3),
        "streamed_total_s": round(t_stream, 3),
        "expansion_overhead": round(
            max(0.0, t_stream - t_rotate_total) / t_stream, 3),
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
