"""Per-op device-trace breakdown of the gate bootstrap on the GPU.

Captures a profiler trace of one bootsAND batch on the F-block key and
prints the per-category device time (GEMMs vs elementwise fusions vs
copies), the top ops, the device's idle share over the traced window, and
the trace's plane/line map. Writes summary.json and lanes.json beside the
trace.

    python benchmarks/profile_trace.py [--batch 4096] [--logdir .cache/trace]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from torus_fhe_tpu.boot import api, gates
    from torus_fhe_tpu.core.params import (tfhe_parameters_128_tpu,
                                           tfhe_parameters_128_tpu_fast)
    from torus_fhe_tpu.utils import profiling
    from torus_fhe_tpu.utils.device import REPO_ROOT, configure_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--logdir", default=os.path.join(REPO_ROOT, ".cache",
                                                     "trace"))
    ap.add_argument("--l3", action="store_true")
    args = ap.parse_args()

    configure_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("profile_trace.py: needs a GPU")
    params = (tfhe_parameters_128_tpu() if args.l3
              else tfhe_parameters_128_tpu_fast())
    sk, ck = api.make_key_pair(jax.random.PRNGKey(0), params,
                               forms=("fblock",))
    B = args.batch
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.integers(0, 2, B) == 1)
    cx = api.encrypt(jax.random.PRNGKey(1), sk, xs)
    cy = api.encrypt(jax.random.PRNGKey(2), sk, ~xs)
    step = jax.jit(gates.gate_and)
    jax.block_until_ready(step(ck, cx, cy))  # compile outside the trace

    with profiling.device_trace(args.logdir):
        out = jax.block_until_ready(step(ck, cx, cy))
    assert not np.asarray(api.decrypt(sk, out)).any(), "x AND NOT x != 0"

    summary = profiling.summarize_trace(args.logdir)
    lanes = profiling.trace_lanes(args.logdir)
    print(profiling.format_summary(summary))
    print("trace lanes (plane, line, events, total us):")
    for lane in lanes:
        print(f"  {lane}")
    with open(os.path.join(args.logdir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    with open(os.path.join(args.logdir, "lanes.json"), "w") as fh:
        json.dump(lanes, fh, indent=1)


if __name__ == "__main__":
    main()
