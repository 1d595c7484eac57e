"""Time the exact int8 products on the device at their real widths.

    python benchmarks/int8_products.py

Checks each product bit-exactly first (the `chip_smoke.py` products phase),
then prints one line per timing: the negacyclic product through the
circulant-matmul form (N=1024, R=6 and R=9 input rows; the convolution form
is tried and its compile error reported),
the F-block step contraction and its bare dot at tfhe_128_tpu_fast, and a
large bf16 matrix product as the card's practical reference rate. Needs a GPU.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _time(f, *args, reps: int = 20) -> float:
    """Median seconds per call, each call ended with block_until_ready."""
    import jax

    jax.block_until_ready(f(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from torus_fhe_tpu.ops import fblock, poly
    from torus_fhe_tpu.utils.device import configure_compile_cache

    configure_compile_cache()
    chip_smoke.require_gpu()
    print(f"card: {chip_smoke.card_line()}", flush=True)
    chip_smoke.phase_products()

    rng = np.random.default_rng(1)
    N = 1024
    for R in (6, 9):
        C = R // 3
        kern = rng.integers(-2 ** 31, 2 ** 31, (R, C, N), dtype=np.int64)
        packed = jnp.asarray(poly.pack_kernels_host(kern.astype(np.int32), 32))
        for B in (32, 512):
            d = jnp.asarray(rng.integers(-128, 128, (B, R, N), dtype=np.int64)
                            .astype(np.int8))
            row = []
            for backend in ("conv", "matmul"):
                poly.set_backend(backend)
                f = jax.jit(lambda d, k: poly.negacyclic_extern_product(
                    d, k, 32, C))
                try:
                    row.append(f"{backend} {_time(f, d, packed) * 1e6:.1f} us")
                except Exception as e:  # XLA:GPU refuses the integer conv
                    row.append(f"{backend} refused: {str(e).strip().splitlines()[0]}")
            poly.set_backend(None)
            print(f"[time] negacyclic product N={N} R={R} B={B}: "
                  + ", ".join(row), flush=True)

    geom, _, fstep = chip_smoke._fast_fblock_step(rng)
    for B in (4096, 1):
        d8 = jnp.asarray(rng.integers(-128, 128, (B, geom.R, geom.N),
                                      dtype=np.int64).astype(np.int8))
        f = jax.jit(lambda d, k: fblock.contract_rows_fblock(d, k, geom))
        t = _time(f, d8, fstep)
        a = jnp.asarray(rng.integers(-128, 128, (4 * B, 6144), dtype=np.int64)
                        .astype(np.int8))
        g = jax.jit(lambda x, y: jnp.dot(x, y, preferred_element_type=jnp.int32))
        td = _time(g, a, fstep)
        ops = 2 * 4 * B * 6144 * 1408
        print(f"[time] F-block step B={B}: contraction {t * 1e6:.1f} us, "
              f"bare dot {td * 1e6:.1f} us = {ops / td / 1e12:.1f} TOP/s",
              flush=True)

    x = jnp.asarray(rng.standard_normal((8192, 8192)), jnp.bfloat16)
    h = jax.jit(lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32))
    t = _time(h, x, x)
    print(f"[time] bf16 matmul 8192^3: {2 * 8192 ** 3 / t / 1e12:.1f} TFLOP/s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
