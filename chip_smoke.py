"""Smoke test of the main path on one NVIDIA GPU.

    python chip_smoke.py           # one card: products, gates, CLI, 3gen gate
    python chip_smoke.py --four    # four cards: the multi-device paths only

Every phase prints one line; any failure exits non-zero before the final
line, which is one JSON object naming the device JAX ran on. Without a GPU
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from torus_fhe_tpu.utils.device import configure_compile_cache  # noqa: E402


def require_gpu():
    """The JAX devices, or SystemExit when the first one is not a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devices[0].platform!r}")
    return devices


def card_line() -> str:
    """Name and power limit of every card, read by a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Exact int8 products at their real widths
# ---------------------------------------------------------------------------


def _exact_dot_ref(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Integer a @ b through float64 BLAS. Exact: every partial sum is an
    integer of magnitude below K * max|a| * max|b| < 2^53 (asserted)."""
    bound = a.shape[-1] * int(np.abs(a).max()) * int(np.abs(b).max())
    assert bound < 2 ** 53, bound
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int64)


def _lowering(compiled) -> str:
    """The library calls and fusion kinds the compiled program uses."""
    import re

    text = compiled.as_text()
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', text)))
    kinds = sorted(set(re.findall(r"kind=(k\w+)", text)))
    return f"custom_calls={targets} fusion_kinds={kinds}"


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"mem(arg={m.argument_size_in_bytes}, out={m.output_size_in_bytes}, "
            f"temp={m.temp_size_in_bytes})")


def _check_dot(name: str, a: np.ndarray, b: np.ndarray) -> None:
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x, y: jnp.dot(x, y, preferred_element_type=jnp.int32))
    ad, bd = jnp.asarray(a), jnp.asarray(b)
    compiled = f.lower(ad, bd).compile()
    got = np.asarray(compiled(ad, bd))
    want = _exact_dot_ref(a, b)
    assert np.array_equal(got.astype(np.int64), want), f"{name}: not exact"
    say("products", f"{name} {a.shape}@{b.shape} s8xs8->s32 bit-exact; "
        f"max|sum|={int(np.abs(want).max())}; {_lowering(compiled)}; "
        f"{_mem(compiled)}")


def _fast_fblock_step(rng):
    """One expanded F-block step at tfhe_128_tpu_fast from random TGSW
    samples whose body is rounded to 2^8, as keygen rounds it."""
    from torus_fhe_tpu.boot import bootstrap
    from torus_fhe_tpu.core.params import tfhe_parameters_128_tpu_fast
    from torus_fhe_tpu.ops import fblock

    params = tfhe_parameters_128_tpu_fast()
    geom = bootstrap._bk_geometry(params)._replace(n=1)
    l, C, N = params.bs_decomp_length, geom.C, geom.N
    samples = rng.integers(-2 ** 31, 2 ** 31, (1, l, C, C, N), dtype=np.int64)
    samples[:, :, :, C - 1] &= ~0xFF
    samples = samples.astype(np.int32)
    return geom, samples, fblock.build_fblocks(samples, geom)[0]


def check_fblock_contraction(B: int, rng, n_ref: int = 8) -> None:
    """``contract_rows_fblock`` at the real geometry against the schoolbook
    (``negacyclic_polymul_ref``) on ``n_ref`` gates of the batch."""
    import jax
    import jax.numpy as jnp

    from torus_fhe_tpu.ops import fblock, poly
    from torus_fhe_tpu.utils.device import on_host

    geom, samples, fstep = _fast_fblock_step(rng)
    R, C, N = geom.R, geom.C, geom.N
    d8 = rng.integers(-128, 128, (B, R, N), dtype=np.int64).astype(np.int8)
    f = jax.jit(lambda d, k: fblock.contract_rows_fblock(d, k, geom))
    dd = jnp.asarray(d8)
    compiled = f.lower(dd, fstep).compile()
    got = np.asarray(compiled(dd, fstep))
    kern = samples[0].reshape(R, C, N)
    idx = np.unique(np.linspace(0, B - 1, min(n_ref, B)).astype(int))
    with on_host(), jax.enable_x64(True):
        want = sum(np.asarray(poly.negacyclic_polymul_ref(
            d8[idx, r, None, :].astype(np.int32), kern[r]))
            for r in range(R))
    assert np.array_equal(got[idx], want.astype(np.int32)), \
        f"F-block contraction B={B}: not exact"
    say("products", f"F-block contraction B={B} (dot {(B * geom.nb, R * geom.D * geom.bs)}"
        f"@{tuple(fstep.shape)}) bit-exact vs schoolbook on {len(idx)} gates; "
        f"{_lowering(compiled)}; {_mem(compiled)}")


def check_negacyclic_product(B: int, R: int, rng, N: int = 1024) -> None:
    """``negacyclic_extern_product`` in the form the platform resolves to, at
    N with R input rows, against the schoolbook; digits and kernel limbs are
    large and positive so that a float route would lose low bits."""
    import jax
    import jax.numpy as jnp

    from torus_fhe_tpu.ops import poly
    from torus_fhe_tpu.utils.device import on_host

    C = R // 3
    digits = rng.integers(64, 128, (B, R, N), dtype=np.int64).astype(np.int8)
    limbs = rng.integers(64, 128, (R, C, N, 4), dtype=np.int64)
    kern = (limbs * (256 ** np.arange(4))).sum(-1).astype(np.int32)
    packed = jnp.asarray(poly.pack_kernels_host(kern, 32))
    f = jax.jit(lambda d, k: poly.negacyclic_extern_product(d, k, 32, C))
    dd = jnp.asarray(digits)
    compiled = f.lower(dd, packed).compile()
    got = np.asarray(compiled(dd, packed))
    with on_host(), jax.enable_x64(True):
        want = sum(np.asarray(poly.negacyclic_polymul_ref(
            digits[:, r, None, :].astype(np.int32), kern[r]))
            for r in range(R))
    assert np.array_equal(got, want.astype(np.int32)), \
        f"negacyclic product B={B} R={R}: not exact"
    say("products", f"{poly.resolve_backend()} negacyclic product B={B} R={R} N={N} "
        f"bit-exact vs schoolbook; {_lowering(compiled)}; "
        f"{_mem(compiled)}")


def phase_products(seed: int = 0) -> None:
    from torus_fhe_tpu.core.params import (mktfhe_parameters_2party_3gen,
                                           tfhe_parameters_128_tpu_fast)

    rng = np.random.default_rng(seed)
    # the F-block step's dot, operands large and positive (sums > 2^24)
    p = tfhe_parameters_128_tpu_fast()
    for B in (4096, 1):
        a = rng.integers(64, 128, (4 * B, 6144), dtype=np.int64).astype(np.int8)
        b = rng.integers(64, 128, (6144, 1408), dtype=np.int64).astype(np.int8)
        _check_dot(f"F-block dot B={B}", a, b)
        check_fblock_contraction(B, rng)
    # keyswitch one-hot dots: single-key and 2-party 3gen tables
    for name, n_in, l, lb, cols, B in (
            ("keyswitch", p.rlwe_polynomial_degree * p.rlwe_mask_size,
             p.ks_decomp_length, p.ks_log2_base, (p.lwe_size + 1) * 4, 4096),
            ("3gen keyswitch", 1024, 3, 3,
             2 * (mktfhe_parameters_2party_3gen().lwe_size + 1) * 4, 512)):
        K = n_in * l * ((1 << lb) - 1)
        digits = rng.integers(0, 1 << lb, (B, n_in * l))
        onehot = (digits[..., None] == np.arange(1, 1 << lb)).astype(np.int8)
        mat = rng.integers(-128, 128, (K, cols), dtype=np.int64).astype(np.int8)
        _check_dot(name, onehot.reshape(B, K), mat)
    for R in (6, 9):
        check_negacyclic_product(32, R, rng)


# ---------------------------------------------------------------------------
# Gates, CLI and multikey phases
# ---------------------------------------------------------------------------


def _bits(rng, B: int) -> np.ndarray:
    return rng.integers(0, 2, B).astype(bool)


def _expect(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    bad = int(np.sum(got != want))
    assert bad == 0, f"{what}: {bad} of {want.size} bits decrypt wrong"


def _median_time(f, *args, reps: int):
    """(median seconds, last output) over ``reps`` calls, each ended with
    block_until_ready."""
    import jax

    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def _peak_bytes(device) -> str:
    stats = device.memory_stats() or {}
    return str(stats.get("peak_bytes_in_use", "not reported"))


def phase_gates(params=None, batches=(4096, 1), chain: int = 8,
                reps: int = 5) -> None:
    """Single-key gates through boot.api / boot.gates on the F-block key."""
    import jax

    from torus_fhe_tpu.boot import api, gates
    from torus_fhe_tpu.core.params import tfhe_parameters_128_tpu_fast

    params = params or tfhe_parameters_128_tpu_fast()
    t0 = time.perf_counter()
    sk, ck = api.make_key_pair(jax.random.PRNGKey(0), params,
                               forms=("fblock",))
    jax.block_until_ready(ck)
    say("gates", f"keygen forms=fblock (TGSW on the host CPU backend, F-block "
        f"build on the device): {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(42)
    step = jax.jit(gates.gate_and)
    for B in batches:
        xs, ys = _bits(rng, B), _bits(rng, B)
        cx = api.encrypt(jax.random.PRNGKey(1), sk, xs)
        cy = api.encrypt(jax.random.PRNGKey(2), sk, ys)
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(ck, cx, cy))
        first = time.perf_counter() - t0
        _expect(api.decrypt(sk, out), xs & ys, f"gate_and B={B}")
        dt, out = _median_time(step, ck, cx, cy, reps=reps)
        _expect(api.decrypt(sk, out), xs & ys, f"gate_and B={B} (timed)")
        say("gates", f"gate_and B={B}: compile+first {first:.2f} s, median "
            f"{dt * 1e3:.2f} ms of {reps}, {B / dt:.1f} gates/s, all bits "
            f"decrypt right")

    B = batches[0]

    def nand_chain(ck, x, y):
        return jax.lax.scan(lambda x, _: (gates.gate_nand(ck, x, y), None),
                            x, None, length=chain)[0]

    xs, ys = _bits(rng, B), _bits(rng, B)
    cx = api.encrypt(jax.random.PRNGKey(3), sk, xs)
    cy = api.encrypt(jax.random.PRNGKey(4), sk, ys)
    want = xs
    for _ in range(chain):
        want = ~(want & ys)
    run = jax.jit(nand_chain)
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(ck, cx, cy))
    first = time.perf_counter() - t0
    _expect(api.decrypt(sk, out), want, f"{chain}-step NAND chain")
    dt, out = _median_time(run, ck, cx, cy, reps=max(1, reps // 2))
    _expect(api.decrypt(sk, out), want, f"{chain}-step NAND chain (timed)")
    say("gates", f"{chain}-step gate_nand scan B={B}: compile+first "
        f"{first:.2f} s, median {dt:.3f} s, {B * chain / dt:.1f} gates/s, "
        f"all bits decrypt right; peak_bytes_in_use="
        f"{_peak_bytes(jax.devices()[0])}")


def phase_cli(params_name: str = "tfhe_128_tpu", a: int = 13452,
              b: int = 223416) -> None:
    """keygen -> encrypt -> eval and -> decrypt through cli.main, with the
    default key form."""
    from torus_fhe_tpu import cli

    work = os.path.join(REPO, ".cache", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    sec, cld = (os.path.join(work, f) for f in ("secret.npz", "cloud.npz"))
    ca, cb, co = (os.path.join(work, f) for f in ("a.npz", "b.npz", "c.npz"))

    def run(*argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
        assert rc == 0, (argv, rc, buf.getvalue())
        return buf.getvalue().strip()

    t0 = time.perf_counter()
    run("keygen", "--params", params_name, "--secret", sec, "--cloud", cld)
    keygen_s = time.perf_counter() - t0
    run("encrypt", str(a), "--secret", sec, "--out", ca, "--seed", "1")
    run("encrypt", str(b), "--secret", sec, "--out", cb, "--seed", "2")
    t0 = time.perf_counter()
    run("eval", "and", ca, cb, "--cloud", cld, "--out", co)
    eval_s = time.perf_counter() - t0
    got = int(run("decrypt", co, "--secret", sec))
    assert got == a & b, (got, a & b)
    from torus_fhe_tpu.ops import poly

    say("cli", f"{params_name} keygen {keygen_s:.2f} s, eval and (32 bits, "
        f"load + compile + run) {eval_s:.2f} s, product form "
        f"{poly.resolve_backend()}: decrypt {got} == {a} & {b}")


def phase_mk3gen(params=None, parties: int = 2, B: int = 64) -> None:
    """A 2-party 3gen NAND through mk.gates3gen on the hi-word F-block key."""
    import jax

    jax.config.update("jax_enable_x64", True)  # 64-bit multikey keygen
    from torus_fhe_tpu import mk
    from torus_fhe_tpu.core.params import PARAMETER_REGISTRY
    from torus_fhe_tpu.mk import gates3gen

    params = params or PARAMETER_REGISTRY["mk_2party_3gen"]()
    t0 = time.perf_counter()
    sks = [mk.mk_party_keygen(jax.random.PRNGKey(100 + p), params)
           for p in range(parties)]
    ck = mk.mk_cloud_keygen(jax.random.PRNGKey(200), sks, params,
                            forms=("fblock",))
    jax.block_until_ready(ck)
    keygen_s = time.perf_counter() - t0
    keys = [sk.lwe for sk in sks]
    rng = np.random.default_rng(7)
    xs, ys = _bits(rng, B), _bits(rng, B)
    cx = mk.mk_encrypt(jax.random.PRNGKey(201), keys, xs, params)
    cy = mk.mk_encrypt(jax.random.PRNGKey(202), keys, ys, params)
    t0 = time.perf_counter()
    out = jax.block_until_ready(gates3gen.mk_gate_nand(ck, cx, cy))
    first = time.perf_counter() - t0
    _expect(mk.mk_decrypt(keys, out), ~(xs & ys), "3gen NAND")
    dt, out = _median_time(gates3gen.mk_gate_nand, ck, cx, cy, reps=3)
    _expect(mk.mk_decrypt(keys, out), ~(xs & ys), "3gen NAND (timed)")
    say("mk3gen", f"{parties}-party NAND B={B}: keygen {keygen_s:.2f} s, "
        f"compile+first {first:.2f} s, median {dt * 1e3:.2f} ms, "
        f"{B / dt:.1f} gates/s, all bits decrypt right")


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def phase_four_gates(devices, params=None, B: int = 4096) -> None:
    """Batch-sharded gate_and over four cards == the one-card result."""
    import jax

    from torus_fhe_tpu.boot import api, gates
    from torus_fhe_tpu.core.params import tfhe_parameters_128_tpu_fast
    from torus_fhe_tpu.lwe import LweSample
    from torus_fhe_tpu.parallel import mesh as pmesh

    params = params or tfhe_parameters_128_tpu_fast()
    sk, ck = api.make_key_pair(jax.random.PRNGKey(0), params,
                               forms=("fblock",))
    rng = np.random.default_rng(11)
    xs, ys = _bits(rng, B), _bits(rng, B)
    cx = api.encrypt(jax.random.PRNGKey(1), sk, xs)
    cy = api.encrypt(jax.random.PRNGKey(2), sk, ys)
    one = jax.jit(gates.gate_and)
    ref = jax.block_until_ready(one(ck, cx, cy))
    dt1, _ = _median_time(one, ck, cx, cy, reps=3)

    m = pmesh.make_mesh(n_batch=len(devices), n_party=1, devices=devices)
    ckm = pmesh.replicate_cloud_key(ck, m)
    sx, sy = pmesh.shard_lwe_batch(cx, m), pmesh.shard_lwe_batch(cy, m)
    four = jax.jit(gates.gate_and, out_shardings=pmesh.batch_sharding(m))
    t0 = time.perf_counter()
    out = jax.block_until_ready(four(ckm, sx, sy))
    first = time.perf_counter() - t0
    dt4, out = _median_time(four, ckm, sx, sy, reps=3)
    got = LweSample(np.asarray(out.a), np.asarray(out.b))
    assert np.array_equal(got.a, np.asarray(ref.a)) and \
        np.array_equal(got.b, np.asarray(ref.b)), "4-card != 1-card"
    _expect(api.decrypt(sk, got), xs & ys, "4-card gate_and")
    say("four", f"batch-sharded gate_and B={B} over {len(devices)} cards "
        f"bit-identical to one card and decrypts right; compile+first "
        f"{first:.2f} s; one card {B / dt1:.1f} gates/s, {len(devices)} cards "
        f"{B / dt4:.1f} gates/s")


def phase_four_threshold(devices, params=None) -> None:
    """Party-sharded (3,5) threshold decryption == the sequential pair."""
    import jax

    from torus_fhe_tpu.core.params import thfhe_parameters_1024
    from torus_fhe_tpu.parallel import mesh as pmesh
    from torus_fhe_tpu.parallel import sharded
    from torus_fhe_tpu.rlwe import rlwe_encrypt, rlwe_keygen
    from torus_fhe_tpu.threshold import decrypt as tdec
    from torus_fhe_tpu.threshold import shares as tsh

    rp = (params or thfhe_parameters_1024()).rlwe
    m = pmesh.make_mesh(n_batch=1, n_party=len(devices), devices=devices)
    rk = rlwe_keygen(jax.random.PRNGKey(11), rp)
    repo = tsh.share_secret(np.asarray(rk.key), 3, 5, jax.random.PRNGKey(12))
    mu = tdec.encode_bits(0xBEEF, rp.polynomial_degree, n_bits=16)
    ct = rlwe_encrypt(jax.random.PRNGKey(13), mu, 1e-3, rk, rp)
    sh = repo.subset_shares([1, 2, 4])
    signs = np.ones(sh.shape[0], np.int32)
    signs[0] = -1
    got = sharded.threshold_decrypt_sharded(ct.a, sh, signs, 0.0,
                                            jax.random.PRNGKey(14), m)
    ref = tdec.final_decrypt(ct, tdec.partial_decrypt(
        ct, sh, 0.0, jax.random.PRNGKey(14)))
    assert np.array_equal(np.asarray(got), np.asarray(ref)), \
        "sharded threshold decryption != sequential"
    assert tdec.decode_bits(got, n_bits=16) == 0xBEEF
    say("four", f"party-sharded (3,5) threshold decryption N="
        f"{rp.polynomial_degree} over {len(devices)} cards == sequential "
        f"partial/final decrypt, decodes 0xBEEF")


def phase_four_pipeline(devices, params=None, B: int = 64) -> None:
    """Party-pipelined 4-party 3gen NAND == plaintext NAND."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from torus_fhe_tpu import mk
    from torus_fhe_tpu.core.params import PARAMETER_REGISTRY
    from torus_fhe_tpu.core.torus import encode_message
    from torus_fhe_tpu.mk.samples import mk_lwe_noiseless_trivial
    from torus_fhe_tpu.parallel import mesh as pmesh
    from torus_fhe_tpu.parallel import mk_pipeline

    params = params or PARAMETER_REGISTRY["mk_4party_3gen"]()
    parties = len(devices)
    t0 = time.perf_counter()
    sks = [mk.mk_party_keygen(jax.random.PRNGKey(300 + p), params)
           for p in range(parties)]
    ck = mk.mk_cloud_keygen(jax.random.PRNGKey(301), sks, params, forms=(),
                            keep_samples=True)
    m = pmesh.make_mesh(n_batch=1, n_party=parties, devices=devices)
    sel = mk_pipeline.build_sharded_mk_sel(ck.bk_samples, params, parties, m)
    keygen_s = time.perf_counter() - t0
    keys = [sk.lwe for sk in sks]
    rng = np.random.default_rng(13)
    xs, ys = _bits(rng, B), _bits(rng, B)
    cx = mk.mk_encrypt(jax.random.PRNGKey(302), keys, xs, params)
    cy = mk.mk_encrypt(jax.random.PRNGKey(303), keys, ys, params)
    t = mk_lwe_noiseless_trivial(encode_message(1, 8), params.lwe, parties,
                                 xs.shape) - cx - cy
    t0 = time.perf_counter()
    out = mk_pipeline.mk_bootstrap_pipelined(
        ck, sel, encode_message(1, 8, jax.numpy.int64), t, m, microbatches=4)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    _expect(mk.mk_decrypt(keys, out), ~(xs & ys), "pipelined 3gen NAND")
    say("four", f"party-pipelined {parties}-party 3gen NAND B={B} over "
        f"{len(devices)} cards decrypts right: keygen {keygen_s:.2f} s, "
        f"compile+run {dt:.2f} s")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    configure_compile_cache()
    devices = require_gpu()
    say("device", card_line())
    if "--four" in argv:
        assert len(devices) == 4, f"--four needs 4 cards, found {len(devices)}"
        phase_four_gates(devices)
        phase_four_threshold(devices)
        phase_four_pipeline(devices)
    else:
        phase_products()
        phase_gates()
        phase_cli()
        phase_mk3gen()
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
