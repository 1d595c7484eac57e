"""Bisect which KMS gate phase breaks the compiler at >=4 parties.

The fused 4-party registry-set KMS program has failed to compile on an
earlier accelerator (mk/kms.py, split-phase dispatch). This harness compiles
each phase of the KMS bootstrap SEPARATELY on the real device to localise
such a failure:

    1. streamed gsw blind rotate (fblock.blind_rotate_streamed, 64-bit)
    2. per-party TLev rotate (same, folded batch)
    3. tlev_extern_mul (runtime-kernel relin contraction)
    4. uni_product_new (keygen-packed gadget contractions)
    5. the full gate

    python benchmarks/kms_compile_bisect.py [--parties 4] [--batch 64]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parties", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--phases", default="1,2,3,4,5")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", True)
    from torus_fhe_tpu.utils.device import REPO_ROOT, configure_compile_cache

    configure_compile_cache()

    from torus_fhe_tpu.core.params import PARAMETER_REGISTRY
    from torus_fhe_tpu.mk import kms
    from torus_fhe_tpu.utils import serialize as ser

    P = args.parties
    params = PARAMETER_REGISTRY[f"mk_{P}party_kms"]()
    path = os.path.join(REPO_ROOT, ".cache", "keys",
                        f"perf_kmsfb_p{P}_real.npz")
    print(f"# loading {path}", flush=True)
    ck = ser.load_kms_cloud_key(path)
    B = args.batch
    N = params.rlwe_polynomial_degree
    n = params.lwe_size
    rng = np.random.default_rng(0)
    bara = jnp.asarray(rng.integers(0, 2 * N, (B, P, n), dtype=np.int64),
                       jnp.int32)
    acc = jnp.asarray(rng.integers(-2**63, 2**63, (B, P + 1, N),
                                   dtype=np.int64))

    def attempt(tag, fn, *a):
        t0 = time.time()
        try:
            out = jax.block_until_ready(jax.jit(fn)(*a))
            print(f"PHASE {tag}: OK compile+run {time.time()-t0:.1f}s",
                  flush=True)
            del out
        except Exception as e:
            print(f"PHASE {tag}: FAILED after {time.time()-t0:.1f}s: "
                  f"{str(e)[:300]}", flush=True)

    want = set(args.phases.split(","))
    from torus_fhe_tpu.ops import fblock

    if "1" in want:
        geom = kms.kms_fb_geometry(params, n)
        gp = params.tgsw
        sacc = jnp.concatenate(
            [jnp.zeros((B, 1, N), acc.dtype), acc[:, :1]], axis=1)
        attempt("1 gsw streamed rotate",
                lambda a, b: fblock.blind_rotate_streamed(
                    a, ck.gsw_sel[:n], b, geom, gp.decomp_length,
                    gp.log2_base, gp.offset, chunk=kms._stream_chunk()), sacc, bara[:, 0])
    if "2" in want:
        attempt("2 TLev rotate",
                lambda b: kms._lev_blind_rotate(ck, 1, b, B), bara[:, 1])
    if "3" in want:
        lev = kms.tlev_trivial_one(B, params)
        attempt("3 tlev_extern_mul",
                lambda a, l: kms.tlev_extern_mul(a, l, ck.params), acc, lev)
    if "4" in want:
        attempt("4 uni_product_new",
                lambda a: kms.uni_product_new(a, ck, 1), acc)
    if "5" in want:
        attempt("5 full kms_blind_rotate",
                lambda a, b: kms.kms_blind_rotate(a, ck, b, True), acc, bara)


if __name__ == "__main__":
    main()
