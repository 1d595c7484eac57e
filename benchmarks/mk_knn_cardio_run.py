"""Multikey encrypted-KNN E2E on the reference cardio fixtures -> measurements/.

BASELINE configs[4]: k-party encrypted KNN_medical_data inference end-to-end,
on the reference's own data1.csv, at a REAL registry parameter set, on the
fast (hi-word F-block) path, K=5 like the reference
(src/KNN_medical_data.cpp:655), finishing with the reference's threshold-
decryption tail (:531-572) on each decision bit.

    python benchmarks/mk_knn_cardio_run.py [--parties 2] [--test-rows 2]
    python benchmarks/mk_knn_cardio_run.py --tiny --cpu   # smoke
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CSV = "/root/reference/test/bootstrap_modules/data1.csv"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parties", type=int, default=2)
    ap.add_argument("--test-rows", type=int, default=2)
    ap.add_argument("--train-rows", type=int, default=5)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--shift", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny insecure params (smoke test)")
    ap.add_argument("--batch-tests", action="store_true",
                    help="ride all test rows as one circuit batch axis "
                         "(default: one row at a time)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from torus_fhe_tpu.utils.device import configure_compile_cache

    configure_compile_cache()

    from torus_fhe_tpu.apps import mk_knn
    from torus_fhe_tpu.core.params import (PARAMETER_REGISTRY,
                                           test_parameters_3gen)

    if args.tiny:
        params = test_parameters_3gen(parties=args.parties, n=16, N=64)
        pname = "tiny(insecure)"
    else:
        pname = f"mk_{args.parties}party_3gen"
        params = PARAMETER_REGISTRY[pname]()

    t0 = time.time()
    done = []

    def progress(i, pred):
        print(f"# test row {i}: prediction={pred} "
              f"(+{time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
        done.append(i)

    res = mk_knn.run_mk_pipeline(
        jax.random.PRNGKey(3), params, args.parties, CSV, k=args.k,
        width=args.width, train_rows=args.train_rows,
        test_rows=args.test_rows, scale_shift=args.shift, progress=progress,
        batch_tests=args.batch_tests)
    wall = time.time() - t0

    # the tail must agree with the MK decryption at every bound
    tails_ok = all(
        all(r["bit"] == p for r in tail)
        for p, tail in zip(res["predictions"], res["threshold_tail"]))
    res.update({"tails_match_decryption": tails_ok,
                "wall_s": round(wall, 1),
                "params": pname, "scale_shift": args.shift,
                "train_rows": args.train_rows, "csv": CSV,
                "device": str(jax.devices()[0])})
    out = args.out or os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "measurements", "mk_knn_cardio.json")
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if k != "threshold_tail"}))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
