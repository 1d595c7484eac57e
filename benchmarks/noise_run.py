"""Reference-scale statistical noise run: 1000 trials per parameter set.

Reproduces the methodology of the reference's measurement suites
(3-gen-mk-tfhe/measurements/test_suites/us_simplified/
measurements_us_simplified_3.jl:66-117) and its committed artifacts
(noise_results/mk-noises__parties-2_lambda-1001_pi-2_qw-2.dat — 1000 noise
samples: std 0.0459, |max| 0.317, 4/1000 beyond the 0.25 failure bound —
see docs/MANUAL.md "MK noise envelope"; log_1st_method_errors.log —
wrong-decryption records).

Writes .dat + .log artifacts into measurements/ at the repo root.

Usage:
    python benchmarks/noise_run.py [mk_2party_3gen|tfhe_128_tpu_fast|...] \
        [trials] [--cpu]
"""

from __future__ import annotations

import sys
import time


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    name = args[0] if args else "mk_2party_3gen"
    trials = int(args[1]) if len(args) > 1 else 1000

    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    # the 64-bit-torus MK sets need real int64 (the hot rotate rides the
    # int32-limb streamed form either way)
    jax.config.update("jax_enable_x64", True)

    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    outdir = os.path.join(here, "measurements")

    from torus_fhe_tpu.core.params import (PARAMETER_REGISTRY,
                                           SchemeParams3Gen, SchemeParamsCCS,
                                           SchemeParamsKMS)
    from torus_fhe_tpu.utils import noise

    params = PARAMETER_REGISTRY[name]()
    t0 = time.time()
    if isinstance(params, (SchemeParams3Gen, SchemeParamsCCS,
                           SchemeParamsKMS)):
        scheme = ("3gen" if isinstance(params, SchemeParams3Gen)
                  else "ccs" if isinstance(params, SchemeParamsCCS)
                  else "kms")
        fast = None if "--exact" not in sys.argv else False
        cache = None
        if "--cache" in sys.argv and scheme == "3gen":
            cdir = os.path.join(here, ".cache", "keys")
            os.makedirs(cdir, exist_ok=True)
            cache = os.path.join(cdir, f"noise_{name}.npz")
        rep = noise.measure_multikey(jax.random.PRNGKey(0), params,
                                     params.max_parties, trials=trials,
                                     scheme=scheme, fast_form=fast,
                                     cache_path=cache,
                                     keygen_only="--keygen-only" in sys.argv)
        if rep is None:
            print(f"# keygen-only: cloud key cached at {cache} "
                  f"[{time.time() - t0:.0f}s]")
            return 0
    else:
        rep = noise.measure_single_key(jax.random.PRNGKey(0), params,
                                       trials=trials)
    tag = f"{name}_trials-{trials}" + ("_exact" if "--exact" in sys.argv
                                       else "")
    rep.write_artifacts(outdir, tag)
    print(rep.to_json())
    print(f"artifacts: measurements/noises__{tag}.dat + log__{tag}.log "
          f"[{time.time() - t0:.0f}s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
