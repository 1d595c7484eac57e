"""Cross-scheme multikey bootstrap timing comparison.

Counterpart of the reference's
measurements/test_suites/performance_comparison_test/perf_comp.jl:13-143 —
time one multikey NAND (linear combine + MK bootstrap + keyswitch) for each
scheme {3gen (AKO), CCS, KMS} across party counts, reporting min/median wall
times and amortised per-gate throughput over a batch.

    python benchmarks/perf_comp.py [--parties 2 4] [--batch 64] [--cpu]
                                   [--trials 5] [--n 16 --N 64]

Defaults use tiny insecure parameters so the comparison runs anywhere; on a
real chip pass production sizes (--n 560 --N 1024 ...).
"""

from __future__ import annotations

import argparse
import functools
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def size_tag(args) -> str:
    if getattr(args, "fixed_set", None) is not None:
        return f"fx{args.fixed_set}"
    return "real" if args.real else f"n{args.n}N{args.N}"


def _key_cached(args, name: str, build, save, load):
    """Generic key cache: production host keygens take tens of minutes."""
    cache_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache", "keys")
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{name}_{size_tag(args)}.npz")
    if os.path.exists(path):
        try:
            ck = load(path)
            print(f"# {name}: loaded cached key", file=sys.stderr, flush=True)
            return ck
        except Exception as e:
            print(f"# {name} key cache miss: {str(e)[:100]}", file=sys.stderr)
    ck = build()
    try:
        save(path, ck)
    except Exception as e:
        print(f"# {name} key cache save failed: {str(e)[:100]}",
              file=sys.stderr)
    return ck


def bench_gate(gate_fn, cx, cy, trials):
    walls = []
    out = jax.block_until_ready(gate_fn(cx, cy))  # compile
    for _ in range(trials):
        t0 = time.perf_counter()
        out = jax.block_until_ready(gate_fn(cx, cy))
        walls.append(time.perf_counter() - t0)
    return walls, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parties", type=int, nargs="+", default=[2])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--schemes", nargs="+", default=["3gen", "ccs", "kms"])
    ap.add_argument("--real", action="store_true",
                    help="use the shipped production parameter sets from the "
                         "registry (mk_{p}party_{scheme}) instead of tiny "
                         "test sizes — the reference comparison regime "
                         "(perf_comp.jl:103-143)")
    ap.add_argument("--no-fblock", action="store_true",
                    help="force the conv scan for 3gen too")
    ap.add_argument("--kms-split", action="store_true",
                    help="dispatch the KMS gate as one program per bootstrap "
                         "phase (mk_gate_nand_split) — the workaround for "
                         "registry sets whose fused program does not "
                         "compile in one piece (>=4-party sets)")
    ap.add_argument("--keygen-only", action="store_true",
                    help="build + cache the cloud keys, skip the timing run "
                         "(host keygens are the long pole: run them on CPU "
                         "in the background, then time on the device from cache)")
    ap.add_argument("--fixed-set", default=None, metavar="SUFFIX",
                    help="the reference protocol (perf_comp.jl:15-17): use "
                         "the FIXED registry set mk_<SUFFIX>party_<scheme> "
                         "for every party count instead of the per-count "
                         "set, e.g. --fixed-set 16")
    ap.add_argument("--fb-limit-gb", type=float, default=10.0,
                    help="max expanded F-block size to materialise")
    ap.add_argument("--out", default=None,
                    help="append result rows to this JSON file")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    # the KMS scheme runs on a 64-bit torus (rlwe_bits=64)
    jax.config.update("jax_enable_x64", True)

    from torus_fhe_tpu import mk
    from torus_fhe_tpu.core.params import (test_parameters_3gen,
                                           test_parameters_ccs,
                                           test_parameters_kms)
    from torus_fhe_tpu.mk import ccs as mccs, kms as mkms
    from torus_fhe_tpu.mk import gates3gen
    from torus_fhe_tpu.mk.samples import mk_decrypt, mk_encrypt

    B = args.batch
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.integers(0, 2, B) == 1)
    ys = jnp.asarray(rng.integers(0, 2, B) == 1)
    rows = []

    for parties in args.parties:
        setups = {}
        from torus_fhe_tpu.core.params import PARAMETER_REGISTRY

        def params_for(scheme):
            if args.fixed_set is not None:
                p = PARAMETER_REGISTRY[
                    f"mk_{args.fixed_set}party_{scheme}"]()
                # the registry set pins max_parties; the reference runs it
                # at SMALLER party counts too (perf_comp.jl:13-17)
                import dataclasses

                return dataclasses.replace(p, max_parties=parties)
            if args.real:
                return PARAMETER_REGISTRY[f"mk_{parties}party_{scheme}"]()
            maker = {"3gen": test_parameters_3gen, "ccs": test_parameters_ccs,
                     "kms": test_parameters_kms}[scheme]
            return maker(parties=parties, n=args.n, N=args.N)

        if "3gen" in args.schemes:
            from torus_fhe_tpu.mk.keys3gen import (mk_fb_geometry,
                                                   mk_fb_stream_supported,
                                                   mk_fb_supported)

            p3 = params_for("3gen")
            forms = ("conv",)
            if mk_fb_supported(p3) and not args.no_fblock:
                g = mk_fb_geometry(p3, parties)
                fb_bytes = (g.n * g.D * g.R * g.bs * len(g.cols) * g.bs)
                if fb_bytes <= args.fb_limit_gb * 2**30:
                    forms = ("fblock",)  # the fast F-block path
                else:
                    # expanded key exceeds HBM: the compact/streamed fast form
                    # (chunked on-the-fly expansion — the >=4-party one-chip
                    # answer, ops/fblock.blind_rotate_streamed)
                    forms = ("fbstream",)
                    print(f"# 3gen p={parties}: F-block would be "
                          f"{fb_bytes / 2**30:.1f} GB > --fb-limit-gb; "
                          f"using the streamed compact form", file=sys.stderr)
            elif mk_fb_stream_supported(p3) and not args.no_fblock:
                # wide-digit gadgets (>=16 parties): exact 64-bit streamed form
                forms = ("fbstream",)
                print(f"# 3gen p={parties}: wide-digit gadget -> exact "
                      f"64-bit streamed form", file=sys.stderr)
            sks = [mk.mk_party_keygen(jax.random.PRNGKey(10 + p), p3)
                   for p in range(parties)]
            # key cache: host keygen at production sizes takes tens of
            # minutes; the compact samples round-trip through serialize and
            # rebuild the requested fast form on load
            from torus_fhe_tpu.utils import serialize as _ser

            ck = _key_cached(
                args, f"perf_3gen_p{parties}",
                lambda: mk.mk_cloud_keygen(jax.random.PRNGKey(9), sks, p3,
                                           forms=forms, keep_samples=True),
                _ser.save_mk_cloud_key,
                lambda path: _ser.load_mk_cloud_key(path, forms=forms))
            assert ck.params == p3
            # pass ck as a traced ARG: a closure capture would bake the (multi-GB)
            # F-block key into the program as a constant and hang compilation
            gate = functools.partial(
                jax.jit(lambda _ck, x, y: gates3gen.mk_gate_nand(_ck, x, y)),
                ck)
            tag = {"fblock": "3gen-fb", "fbstream": "3gen-fbs",
                   "conv": "3gen"}[forms[0]]
            setups[tag] = (p3, [s.lwe for s in sks], gate)
        if "ccs" in args.schemes:
            pc = params_for("ccs")
            ccs_forms = ("conv",) if args.no_fblock else ("fb",)
            from torus_fhe_tpu.utils import serialize as _ser

            sks = [mccs.ccs_party_keygen(jax.random.PRNGKey(20 + p), pc)
                   for p in range(parties)]
            ck = _key_cached(
                args, f"perf_ccs{'fb' if ccs_forms == ('fb',) else ''}"
                      f"_p{parties}",
                lambda: mccs.ccs_cloud_keygen(jax.random.PRNGKey(19), sks, pc,
                                              forms=ccs_forms),
                _ser.save_ccs_cloud_key, _ser.load_ccs_cloud_key)
            gate = functools.partial(
                jax.jit(lambda _ck, x, y: mccs.mk_gate_nand(_ck, x, y)), ck)
            setups["ccs-fb" if ccs_forms == ("fb",) else "ccs"] = (
                pc, [s.lwe for s in sks], gate)
        if "kms" in args.schemes:
            pk_ = params_for("kms")
            kms_forms = ("conv",) if args.no_fblock else ("fb",)
            from torus_fhe_tpu.utils import serialize as _ser

            sks = [mkms.kms_party_keygen(jax.random.PRNGKey(30 + p), pk_)
                   for p in range(parties)]
            ck = _key_cached(
                args, f"perf_kms{'fb' if kms_forms == ('fb',) else ''}"
                      f"_p{parties}",
                lambda: mkms.kms_cloud_keygen(jax.random.PRNGKey(29), sks, pk_,
                                              forms=kms_forms),
                _ser.save_kms_cloud_key, _ser.load_kms_cloud_key)
            if args.kms_split:
                gate = functools.partial(mkms.mk_gate_nand_split, ck)
                name = "kms-fbsplit"
            else:
                gate = functools.partial(
                    jax.jit(lambda _ck, x, y: mkms.mk_gate_nand(_ck, x, y)),
                    ck)
                name = "kms-fb" if kms_forms == ("fb",) else "kms"
            setups[name] = (pk_, [s.lwe for s in sks], gate)

        if args.keygen_only:
            print(f"# keygen-only: p={parties} keys cached for "
                  f"{sorted(setups)}", file=sys.stderr, flush=True)
            continue

        for name, (params, lwe_keys, gate) in setups.items():
            try:
                cx = mk_encrypt(jax.random.PRNGKey(1), lwe_keys, xs, params)
                cy = mk_encrypt(jax.random.PRNGKey(2), lwe_keys, ys, params)
                walls, out = bench_gate(gate, cx, cy, args.trials)
                got = np.asarray(mk_decrypt(lwe_keys, out))
                ok = bool(np.array_equal(got,
                                         ~(np.asarray(xs) & np.asarray(ys))))
            except Exception as e:  # OOM etc: keep the other schemes' rows
                print(f"# {name} p={parties} FAILED: {str(e)[:200]}",
                      file=sys.stderr, flush=True)
                continue
            row = (parties, name, min(walls), statistics.median(walls),
                   B / min(walls), ok)
            rows.append(row)
            print(f"# row: p={parties} {name} min={row[2]:.4f}s "
                  f"{row[4]:.1f} gates/s ok={ok}", file=sys.stderr, flush=True)

    if args.fixed_set is not None:
        size = f"fixed-set mk_{args.fixed_set}party (reference protocol)"
    elif args.real:
        size = "registry(real)"
    else:
        size = f"n={args.n} N={args.N}"
    print(f"# device={jax.devices()[0]} batch={B} {size}")
    print(f"{'parties':>7s} {'scheme':>8s} {'min_s':>9s} {'median_s':>9s} "
          f"{'gates/s':>10s} {'correct':>7s}")
    for p, name, mn, md, thr, ok in rows:
        print(f"{p:7d} {name:>8s} {mn:9.4f} {md:9.4f} {thr:10.1f} {str(ok):>7s}")

    if args.out:
        import json

        payload = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                payload = json.load(f)
        for p, name, mn, md, thr, ok in rows:
            payload.append({
                "parties": p, "scheme": name, "batch": B, "size": size,
                "min_s": round(mn, 4), "median_s": round(md, 4),
                "gates_per_s": round(thr, 2), "correct": ok,
                "device": str(jax.devices()[0]), "trials": args.trials})
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
