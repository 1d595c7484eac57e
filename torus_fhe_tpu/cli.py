"""File-based CLI — the reference's cloud/client workflow binaries.

Mirrors the reference's user-facing programs over the npz serialization layer
(keys and ciphertexts round-trip through files exactly like the reference's
`test/` directory, README.md:46-50):

* ``keygen``  — bin/keygen (src/KeyGen.cpp:31-57): write secret + cloud keys.
* ``encrypt`` — bitwise-encrypt an integer (BitwiseEncrypt, src/Convert.cpp:35-39).
* ``eval``    — homomorphic word op under the cloud key (Evaluate,
  src/Convert.cpp:29-33 / src/Compute.cpp:6-11).
* ``decrypt`` — bitwise decrypt with the secret key.
* ``convert`` — the bin/convert scenario (src/Convert.cpp:49-115): AND two
  ints, LWE→TLWE, (3,5)-threshold decrypt across the 0.0125→1e-3 bound sweep.
* ``tlwetn``  — the bin/tlwetn scenario (src/TLwe_TN.cpp:19-147): ring-LWE
  encrypt 32 bits, shareSecret2, per-party partial + final decrypt across the
  0.0625→1e-3 bound sweep.
* ``knn``     — the bin/KNN_medical_data scenario
  (src/KNN_medical_data.cpp:818-851): encrypted KNN over a cardio CSV,
  single-key or k-party multikey, with the threshold-decryption tail.

Usage: ``python -m torus_fhe_tpu <command> ...`` (see --help per command).
"""

from __future__ import annotations

import argparse
import sys
import time


def _keygen(args) -> int:
    import jax

    from .boot import api
    from .core.params import PARAMETER_REGISTRY
    from .utils import serialize

    params = PARAMETER_REGISTRY[args.params]()
    key = jax.random.PRNGKey(args.seed)
    forms = tuple(args.forms.split(","))
    t0 = time.time()
    sk, ck = api.make_key_pair(key, params, forms=forms)
    serialize.save_secret_key(args.secret, sk)
    serialize.save_cloud_key(args.cloud, ck)
    print(f"keygen({args.params}, forms={args.forms}) -> {args.secret}, "
          f"{args.cloud} [{time.time() - t0:.1f}s]")
    return 0


def _encrypt(args) -> int:
    import jax

    from .circuits import words
    from .utils import serialize

    sk = serialize.load_secret_key(args.secret)
    ct = words.int_encrypt(jax.random.PRNGKey(args.seed), sk, args.value,
                           args.bits)
    serialize.save_lwe(args.out, ct, sk.params)
    print(f"encrypt({args.value}, {args.bits} bits) -> {args.out}")
    return 0


def _eval(args) -> int:
    from .boot import gates
    from .utils import serialize

    forms = tuple(args.forms.split(",")) if args.forms else None
    ck = serialize.load_cloud_key(args.cloud, forms=forms)
    a = serialize.load_lwe(args.a)
    b = serialize.load_lwe(args.b) if args.b else None
    op = {"and": gates.gate_and, "or": gates.gate_or, "xor": gates.gate_xor,
          "nand": gates.gate_nand, "nor": gates.gate_nor,
          "xnor": gates.gate_xnor}[args.op]
    t0 = time.time()
    out = op(ck, a, b) if b is not None else op(ck, a)
    out.b.block_until_ready()
    serialize.save_lwe(args.out, out, ck.params)
    print(f"eval({args.op}) -> {args.out} [{time.time() - t0:.1f}s]")
    return 0


def _decrypt(args) -> int:
    from .circuits import words
    from .utils import serialize

    sk = serialize.load_secret_key(args.secret)
    ct = serialize.load_lwe(args.infile)
    value = int(words.int_decrypt(sk, ct, args.bits))
    print(value)
    return 0


def _convert(args) -> int:
    """src/Convert.cpp:49-115 end-to-end at the keyfile's parameters."""
    import jax
    import numpy as np

    from .boot import gates
    from .circuits import words
    from .threshold import convert as tconv
    from .threshold import decrypt as tdec
    from .threshold import shares as tsh
    from .utils import serialize

    sk = serialize.load_secret_key(args.secret)
    ck = serialize.load_cloud_key(args.cloud)
    bits = args.bits

    ca = words.int_encrypt(jax.random.PRNGKey(args.seed), sk, args.x, bits)
    cb = words.int_encrypt(jax.random.PRNGKey(args.seed + 1), sk, args.y, bits)
    t0 = time.time()
    cand = gates.gate_and(ck, ca, cb)  # all bit positions in one batch
    cand.b.block_until_ready()
    want = (args.x & args.y) & ((1 << bits) - 1)
    direct = int(words.int_decrypt(sk, cand, bits))
    print(f"AND: expected {want}, direct decrypt {direct} "
          f"[{time.time() - t0:.1f}s]")

    # LWE -> TLWE under the ring-read key, (3,5)-threshold decrypt
    rkey = tconv.tlwe_key_from_lwe_key(sk.key)
    repo = tsh.share_secret_streaming(np.asarray(rkey.key), 3, 5,
                                      jax.random.PRNGKey(args.seed + 2))
    ring = tconv.tlwe_from_lwe(cand)  # (bits, 2, n)
    subset = [1, 2, 4]
    bound = 0.0125
    ok = True
    while bound > 1e-3:
        got = 0
        for i in range(bits):
            from .rlwe import RLweSample

            plain = tdec.threshold_decrypt(
                RLweSample(ring.a[i]), repo, subset, bound,
                jax.random.fold_in(jax.random.PRNGKey(args.seed + 3), i))
            # sign decode of coefficient 0 (Convert.cpp:110: coefsT[0] > 0)
            got |= (1 if int(np.asarray(jax.device_get(plain))[..., 0]) > 0
                    else 0) << i
        status = "OK" if got == want else "WRONG"
        ok = ok and (got == want)
        print(f"threshold bound={bound:<8g} subset={subset} -> {got} [{status}]")
        bound /= 2
    return 0 if ok and direct == want else 1


def _tlwetn(args) -> int:
    """src/TLwe_TN.cpp:19-147: (t,p) ring sharing + threshold decryption."""
    import jax
    import numpy as np

    from .core.params import RLweParams
    from .rlwe import rlwe_encrypt, rlwe_keygen, rlwe_phase
    from .threshold import decrypt as tdec
    from .threshold import shares as tsh

    t, p, ids = args.t, args.p, args.ids
    ids = sorted(set(ids))
    if len(ids) < t:
        print(f"need at least {t} unique party ids, got {ids}", file=sys.stderr)
        return 2

    # TLweParams(1024, k=2, 0.01, 0.2) (TLwe_TN.cpp:52)
    params = RLweParams(polynomial_degree=1024, mask_size=2, bits=32)
    rkey = rlwe_keygen(jax.random.PRNGKey(args.seed), params)
    msg = args.value & 0xFFFFFFFF
    mu = tdec.encode_bits(msg, params.polynomial_degree)
    ct = rlwe_encrypt(jax.random.PRNGKey(args.seed + 1), mu, 0.001, rkey, params)

    direct = tdec.decode_bits(rlwe_phase(ct, rkey))
    print(f"message {msg}, direct decrypt {direct}")

    t0 = time.time()
    repo = tsh.share_secret_streaming(np.asarray(rkey.key), t, p,
                                      jax.random.PRNGKey(args.seed + 2))
    print(f"shareSecret2({t},{p}) [{time.time() - t0:.2f}s]")

    bound = 0.0625
    while bound > 1e-3:
        t1 = time.time()
        sh = repo.subset_shares(ids)
        partials = tdec.partial_decrypt(
            ct, sh, bound, jax.random.PRNGKey(args.seed + 3))
        got = tdec.decode_bits(tdec.final_decrypt(ct, partials))
        status = "OK" if got == msg else "WRONG"
        print(f"bound={bound:<8g} parties={ids[:t]} -> {got} [{status}] "
              f"[{time.time() - t1:.2f}s]")
        bound /= 2
    return 0


def _knn(args) -> int:
    """bin/KNN_medical_data (src/KNN_medical_data.cpp:818-851): encrypted KNN
    over a cardio-style CSV — single-key or k-party multikey — with the
    (3,5)-threshold-decryption tail on each decision bit."""
    import json

    import jax

    if args.parties > 1:
        from .apps import mk_knn
        from .core.params import PARAMETER_REGISTRY, test_parameters_3gen

        jax.config.update("jax_enable_x64", True)
        params = (test_parameters_3gen(parties=args.parties, n=16, N=64)
                  if args.tiny else
                  PARAMETER_REGISTRY[f"mk_{args.parties}party_3gen"]())
        res = mk_knn.run_mk_pipeline(
            jax.random.PRNGKey(args.seed), params, args.parties, args.csv,
            k=args.k, width=args.width, train_rows=args.train_rows,
            test_rows=args.test_rows, scale_shift=args.shift,
            threshold_tail=not args.no_tail)
    else:
        from .apps import knn
        from .boot import api
        from .core.params import PARAMETER_REGISTRY, test_parameters

        params = (test_parameters(n=16, N=64) if args.tiny
                  else PARAMETER_REGISTRY[args.params]())
        sk, ck = api.make_key_pair(jax.random.PRNGKey(args.seed), params)
        res = knn.run_pipeline(
            jax.random.PRNGKey(args.seed + 1), sk, ck, args.csv, k=args.k,
            width=args.width, train_rows=args.train_rows,
            test_rows=args.test_rows, scale_shift=args.shift,
            with_threshold_tail=not args.no_tail)
    print(json.dumps(res))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torus_fhe_tpu",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="force the jax backend")
    sub = ap.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("keygen", help="generate secret + cloud keys")
    k.add_argument("--params", default="tfhe_128_tpu")
    k.add_argument("--secret", default="secret.key.npz")
    k.add_argument("--cloud", default="cloud.key.npz")
    k.add_argument("--seed", type=int, default=0)
    k.add_argument("--forms", default="conv",
                   help="comma-separated bootstrapping-key forms to "
                        "materialise: conv (limb-kernel scan) and/or fblock "
                        "(the F-block GEMM scan, the fast path); the saved "
                        "key is compact either way and eval rebuilds these "
                        "forms on load")
    k.set_defaults(fn=_keygen)

    e = sub.add_parser("encrypt", help="bitwise-encrypt an integer")
    e.add_argument("value", type=int)
    e.add_argument("--secret", default="secret.key.npz")
    e.add_argument("--bits", type=int, default=32)
    e.add_argument("--out", default="ct.npz")
    e.add_argument("--seed", type=int, default=1)
    e.set_defaults(fn=_encrypt)

    v = sub.add_parser("eval", help="homomorphic gate on encrypted words")
    v.add_argument("op", choices=["and", "or", "xor", "nand", "nor", "xnor"])
    v.add_argument("a")
    v.add_argument("b", nargs="?")
    v.add_argument("--cloud", default="cloud.key.npz")
    v.add_argument("--out", default="out.npz")
    v.add_argument("--forms", default=None,
                   help="override the BK form(s) to rebuild from the key "
                        "file (default: the forms recorded at keygen)")
    v.set_defaults(fn=_eval)

    d = sub.add_parser("decrypt", help="decrypt an integer word")
    d.add_argument("infile")
    d.add_argument("--secret", default="secret.key.npz")
    d.add_argument("--bits", type=int, default=32)
    d.set_defaults(fn=_decrypt)

    c = sub.add_parser("convert", help="bin/convert scenario")
    c.add_argument("x", type=int)
    c.add_argument("y", type=int)
    c.add_argument("--secret", default="secret.key.npz")
    c.add_argument("--cloud", default="cloud.key.npz")
    c.add_argument("--bits", type=int, default=32)
    c.add_argument("--seed", type=int, default=10)
    c.set_defaults(fn=_convert)

    kn = sub.add_parser("knn", help="bin/KNN_medical_data scenario "
                                    "(single-key or k-party multikey)")
    kn.add_argument("csv", help="cardio-style CSV (id, features..., label)")
    kn.add_argument("--parties", type=int, default=1,
                    help=">1 runs the multikey pipeline (apps/mk_knn)")
    kn.add_argument("--k", type=int, default=5)
    kn.add_argument("--width", type=int, default=16)
    kn.add_argument("--shift", type=int, default=4)
    kn.add_argument("--train-rows", type=int, default=5)
    kn.add_argument("--test-rows", type=int, default=1)
    kn.add_argument("--params", default="tfhe_128_tpu_fast")
    kn.add_argument("--tiny", action="store_true",
                    help="tiny insecure parameters (smoke)")
    kn.add_argument("--no-tail", action="store_true",
                    help="skip the (3,5)-threshold-decryption tail")
    kn.add_argument("--seed", type=int, default=30)
    kn.set_defaults(fn=_knn)

    tn = sub.add_parser("tlwetn", help="bin/tlwetn scenario")
    tn.add_argument("t", type=int)
    tn.add_argument("p", type=int)
    tn.add_argument("ids", type=int, nargs="+")
    tn.add_argument("--value", type=int, default=13452)  # test/plain22.txt
    tn.add_argument("--seed", type=int, default=20)
    tn.set_defaults(fn=_tlwetn)

    args = ap.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
