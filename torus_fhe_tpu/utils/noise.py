"""Statistical noise / wrong-decryption measurement harness.

Rework of the reference's measurement suites
(3-gen-mk-tfhe/measurements/test_suites/*, e.g.
measurements_us_simplified_3.jl:66-117): per parameter set, run N trials of
encrypt → bootstrap → phase, record the torus noise of fresh and bootstrapped
ciphertexts (`noise_calc`, numeric-functions.jl:117-132), classify wrong
decryptions (phase out of [0, 1/4] band — docs/3gen/MANUAL.md:106-113), and
report key sizes and bootstrap wall times. Results mirror the reference's
.dat rows; the trial axis is one vmapped batch instead of a Julia loop.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core.torus import encode_message, noise_calc


@dataclasses.dataclass
class NoiseReport:
    trials: int
    fresh_noise_std: float
    fresh_noise_max: float
    boot_noise_std: float
    boot_noise_max: float
    wrong_decryptions: int
    wrong_indices: list
    bk_bytes: int
    ks_bytes: int
    bootstrap_wall_s: float
    # error-class taxonomy (docs/3gen/MANUAL.md:106-113,
    # measurements_us_simplified_3.jl:126-160): the mod-switch-ROUNDED
    # pre-bootstrap gate phase, mapped to the expected-positive frame, is
    # classified over ALL trials against the (0, 1/4) band — > 1/4 means the
    # rounding pushed the phase past the test-vector half (wrong phase,
    # still a correct decryption); < 0 means the rounded phase crossed the
    # sign boundary (wrong phase AND wrong decryption)
    wrong_phase_gt_quarter: int = 0
    wrong_phase_lt_zero: int = 0
    boot_noises: np.ndarray | None = None  # raw per-trial bootstrapped noise
    fresh_noises: np.ndarray | None = None
    # pre-keyswitch split (3gen MK): noise of the extracted sample BEFORE the
    # per-party keyswitch, under the summed extracted ring key — separates
    # blind-rotate accumulation from keyswitch contribution
    pre_ks_noise_std: float | None = None
    pre_ks_noise_max: float | None = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.pop("boot_noises", None)
        d.pop("fresh_noises", None)
        return json.dumps(d)

    def write_artifacts(self, directory: str, tag: str) -> None:
        """Reference-style result files (noise_results/mk-noises__*.dat and
        log_1st_method_errors.log): one bootstrapped-noise value per line,
        wrong decryptions logged with class + full context."""
        import os

        os.makedirs(directory, exist_ok=True)
        if self.boot_noises is not None:
            with open(os.path.join(directory, f"noises__{tag}.dat"), "w") as f:
                for v in np.asarray(self.boot_noises).ravel():
                    f.write(f"{float(v):.17g}\n")
        with open(os.path.join(directory, f"log__{tag}.log"), "w") as f:
            f.write(f"# {tag}: {self.to_json()}\n")
            for idx, cls in zip(self.wrong_indices, self.wrong_classes):
                noise = (float(np.asarray(self.boot_noises).ravel()[idx])
                         if self.boot_noises is not None else float("nan"))
                f.write(f"wrong_decryption trial={idx} class={cls} "
                        f"noise={noise:.6g}\n")

    wrong_classes: list = dataclasses.field(default_factory=list)


def _rounded_phase_classes(phase_pos: np.ndarray, wrong: np.ndarray):
    """Reference taxonomy (measurements_us_simplified_3.jl:126-160): the
    mod-switch-rounded gate phase in the expected-positive frame, checked
    against the (0, 1/4) band over ALL trials. Returns
    (n_gt_quarter, n_lt_zero, classes_for_wrong_indices)."""
    n_gt = int(np.sum(phase_pos > 0.25))
    n_lt = int(np.sum(phase_pos < 0.0))
    classes = []
    for idx in wrong:
        p = float(phase_pos[idx])
        classes.append("rounded_phase_gt_quarter" if p > 0.25
                       else "rounded_phase_lt_zero" if p < 0.0
                       else "boot_noise")  # rounded phase in band: the
        # bootstrap itself (not the mod-switch) produced the wrong bit
    return n_gt, n_lt, classes


def _round_mod_switch(a, b, N: int):
    """Mod-switch round an LWE/MK mask+body to the 2N message space and map
    back (the reference's temp_bara/temp_barb re-encode,
    measurements_us_simplified_3.jl:137-143)."""
    from ..core.torus import decode_message, encode_message

    return (encode_message(decode_message(a, 2 * N), 2 * N, a.dtype),
            encode_message(decode_message(b, 2 * N), 2 * N, b.dtype))


def measure_single_key(key, params, trials: int = 1000) -> NoiseReport:
    """Single-key harness: NAND-style bootstrap noise over a trial batch."""
    from ..boot import api, gates
    from ..lwe import lwe_phase

    k1, k2, k3 = jax.random.split(key, 3)
    # the F-block key: the form the gates' rotate resolver runs
    sk, ck = api.make_key_pair(k1, params, forms=("fblock",))

    msgs = jax.random.bernoulli(k2, 0.5, (trials,))
    ct = api.encrypt(k3, sk, msgs)
    mu = jnp.where(msgs, encode_message(1, 8), encode_message(-1, 8))
    fresh = np.asarray(noise_calc(mu, lwe_phase(ct, sk.key)))

    t0 = time.time()
    # bootstrapped AND with an encryption of True: output encodes msgs
    true_ct = api.encrypt(jax.random.fold_in(key, 9), sk,
                          jnp.ones((trials,), bool))
    out = gates.gate_and(ck, ct, true_ct)
    out.b.block_until_ready()
    wall = time.time() - t0

    phase = np.asarray(lwe_phase(out, sk.key))
    boot = np.asarray(noise_calc(mu, phase))
    dec = phase > 0
    want = np.asarray(msgs)
    wrong = np.nonzero(dec != want)[0]

    # reference-faithful rounded-phase taxonomy: form the next gate's affine
    # combination from TWO bootstrapped ciphertexts (the reference combines
    # two bootstrapped operands, measurements_us_simplified_3.jl:131-143) —
    # NAND(out, out_true) = !want keeps the ideal phase at +-1/8 for both
    # operand values (a same-operand combination would sit at 3/8 half the
    # time, a structural out-of-band count, not noise) — mod-switch round it
    # to 2N, and classify its phase over ALL trials.
    from ..lwe import LweSample

    out_true = gates.gate_and(ck, true_ct, true_ct)  # bootstrapped True
    N = params.rlwe_polynomial_degree
    temp = LweSample(-(out.a + out_true.a),
                     encode_message(1, 8) - (out.b + out_true.b))
    ra, rb = _round_mod_switch(temp.a, temp.b, N)
    phase_r = np.asarray(lwe_phase(LweSample(ra, rb), sk.key))
    phase_pos = np.where(~want, 1.0, -1.0) * (
        phase_r.astype(np.float64) / 2.0**32)
    n_gt, n_lt, classes = _rounded_phase_classes(phase_pos, wrong)

    bk = ck.bootstrap_key
    bk_bytes = (bk.kernels if bk.kernels is not None else bk.fb).nbytes
    ks_bytes = ck.keyswitch_key.mat.nbytes
    return NoiseReport(trials, float(fresh.std()), float(np.abs(fresh).max()),
                       float(boot.std()), float(np.abs(boot).max()),
                       int(wrong.size), wrong.tolist()[:16], bk_bytes, ks_bytes,
                       wall, wrong_phase_gt_quarter=n_gt,
                       wrong_phase_lt_zero=n_lt, wrong_classes=classes[:16],
                       boot_noises=boot, fresh_noises=fresh)


def measure_multikey(key, params, parties: int, trials: int = 1000,
                     scheme: str = "3gen",
                     fast_form: bool | None = None,
                     cache_path: str | None = None,
                     keygen_only: bool = False) -> NoiseReport | None:
    """Multikey harness for all three schemes (measurements_us_simplified_* /
    CCS & KMS suites: fresh + bootstrapped noise, the two wrong-decryption
    classes, BK/KSK sizes, timings). ``scheme``: "3gen" | "ccs" | "kms".

    ``fast_form``: for 3gen, measure the hi-word F-block fast path (includes
    its BK-rounding noise — the shipped fast configuration) instead of the
    exact 64-bit scan; default: fast when the set supports it.

    ``cache_path`` (3gen only): serialize round-trip for the cloud key, so
    the tens-of-minutes host keygen at production >=16-party sets can run
    once on CPU (``keygen_only=True``) and the trial batch on the device
    loads it.
    Party secret keys are cheap and rebuilt deterministically from ``key``."""
    from ..mk.samples import mk_encrypt, mk_lwe_phase

    if scheme == "3gen":
        from .. import mk
        from ..mk import gates3gen
        from ..mk.keys3gen import mk_fb_stream_supported, mk_fb_supported

        if fast_form is None:
            fast_form = mk_fb_supported(params) or mk_fb_stream_supported(
                params)
        if fast_form and mk_fb_supported(params):
            # pick the expanded or streamed fast form by size (the shipped
            # >=4-party configuration is the streamed compact key)
            from ..mk.keys3gen import mk_fb_geometry

            g = mk_fb_geometry(params, parties)
            fb_bytes = g.n * g.D * g.R * g.bs * len(g.cols) * g.bs
            forms = ("fblock",) if fb_bytes <= 10 * 2**30 else ("fbstream",)
        elif fast_form and mk_fb_stream_supported(params):
            # wide-digit (Bg>2^8) sets: the exact 64-bit streamed form — the
            # form the >=16-party rows actually run (hi-word rounding is
            # noise-unsafe there, keys3gen.mk_fb_supported)
            forms = ("fbstream",)
        else:
            forms = ("conv",)
        sks = [mk.mk_party_keygen(jax.random.fold_in(key, 100 + p), params)
               for p in range(parties)]
        ck = None
        if cache_path is not None:
            import os as _os

            from . import serialize as _ser

            if _os.path.exists(cache_path):
                ck = _ser.load_mk_cloud_key(cache_path, forms=forms)
        if ck is None:
            ck = mk.mk_cloud_keygen(
                jax.random.fold_in(key, 7), sks, params, forms=forms,
                keep_samples=cache_path is not None)
            if cache_path is not None:
                _ser.save_mk_cloud_key(cache_path, ck)
        if keygen_only:
            return None
        lwe_keys = [sk.lwe for sk in sks]
        gate = lambda a, b: gates3gen.mk_gate_and(ck, a, b)
        bk_bytes = next(a for a in (ck.bk_kernels, ck.bk_fb, ck.bk_fb_sel)
                        if a is not None).nbytes
        ks_bytes = ck.ks_mat.nbytes
    elif scheme == "ccs":
        from ..mk import ccs

        sks = [ccs.ccs_party_keygen(jax.random.fold_in(key, 100 + p), params)
               for p in range(parties)]
        ck = ccs.ccs_cloud_keygen(jax.random.fold_in(key, 7), sks, params)
        lwe_keys = [sk.lwe for sk in sks]
        gate = lambda a, b: ccs.mk_gate_nand(ck, a, b)
        bk_bytes = (ck.d_kern.nbytes + ck.f0_kern.nbytes + ck.f1_kern.nbytes
                    + ck.pk_kern.nbytes + ck.sk_kern.nbytes)
        ks_bytes = ck.ks_mats.nbytes
    elif scheme == "kms":
        from ..mk import kms

        sks = [kms.kms_party_keygen(jax.random.fold_in(key, 100 + p), params)
               for p in range(parties)]
        ck = kms.kms_cloud_keygen(jax.random.fold_in(key, 7), sks, params)
        lwe_keys = [sk.lwe for sk in sks]
        gate = lambda a, b: kms.mk_gate_nand(ck, a, b)
        bk_bytes = (ck.gsw_kern.nbytes + ck.d_kern.nbytes + ck.f0_kern.nbytes
                    + ck.f1_kern.nbytes + ck.pk_kern.nbytes
                    + ck.sk_kern.nbytes)
        ks_bytes = ck.ks_mats.nbytes
    else:
        raise ValueError(scheme)

    msgs = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5, (trials,))
    ct = mk_encrypt(jax.random.fold_in(key, 2), lwe_keys, msgs, params)
    mu = jnp.where(msgs, encode_message(1, 8), encode_message(-1, 8))
    fresh = np.asarray(noise_calc(mu, mk_lwe_phase(ct, lwe_keys)))

    true_ct = mk_encrypt(jax.random.fold_in(key, 3), lwe_keys,
                         jnp.ones((trials,), bool), params)
    t0 = time.time()
    if scheme == "3gen":
        out = gate(ct, true_ct)  # AND(m, 1) = m
        want = np.asarray(msgs)
    else:
        out = gate(ct, true_ct)  # NAND(m, 1) = not m
        want = ~np.asarray(msgs)
    out.b.block_until_ready()
    wall = time.time() - t0

    mu_out = jnp.where(jnp.asarray(want), encode_message(1, 8),
                       encode_message(-1, 8))
    phase = np.asarray(mk_lwe_phase(out, lwe_keys))
    boot = np.asarray(noise_calc(mu_out, phase))
    dec = phase > 0
    wrong = np.nonzero(dec != want)[0]

    pre_ks_std = pre_ks_max = None
    if scheme == "3gen":
        # keyswitch split: noise of the extracted sample BEFORE the per-party
        # keyswitch, under the summed extracted ring key (the implicit key of
        # the AKÖ accumulator: mk_keyswitch applies party p's table to the
        # same mask, so u is keyed by sum_p extract(s_p))
        from ..mk import gates3gen as _g3
        from ..mk.boot3gen import mk_bootstrap_wo_keyswitch
        from ..mk.samples import mk_lwe_noiseless_trivial
        from ..rlwe import extract_lwe_key

        temp_in = mk_lwe_noiseless_trivial(
            encode_message(-1, 8), params.lwe, parties, msgs.shape
        ) + ct + true_ct  # the AND combination measured above
        u = mk_bootstrap_wo_keyswitch(ck, _g3._mu(ck), temp_in)
        bits_u = 8 * u.b.dtype.itemsize
        key_sum = sum(np.asarray(jax.device_get(
            extract_lwe_key(s.rlwe).key), np.int64) for s in sks)
        ua = np.asarray(jax.device_get(u.a), np.int64)
        ub = np.asarray(jax.device_get(u.b), np.int64)
        with np.errstate(over="ignore"):
            phase_u = ub - ua @ key_sum  # int64 wraps (exact for bits=64)
        if bits_u == 32:
            phase_u = phase_u % (1 << 32)
            phase_u = np.where(phase_u >= (1 << 31), phase_u - (1 << 32),
                               phase_u)
        dt_u = jnp.int32 if bits_u == 32 else jnp.int64
        mu_u = jnp.where(jnp.asarray(want), encode_message(1, 8, dt_u),
                         encode_message(-1, 8, dt_u))
        pre = np.asarray(noise_calc(mu_u, phase_u.astype(
            np.int32 if bits_u == 32 else np.int64)))
        pre_ks_std = float(pre.std())
        pre_ks_max = float(np.abs(pre).max())

    # rounded-phase taxonomy on the next gate's combination of TWO
    # bootstrapped inputs (measurements_us_simplified_3.jl:131-160):
    # NAND(out, out_true) = !want, ideal phase +-1/8 for both operand values
    from ..mk.samples import MKLweSample

    out_true = gate(true_ct, true_ct)
    if scheme != "3gen":  # NAND(1,1) = 0: re-encode as a bootstrapped True
        out_true = -out_true
    N = params.rlwe_polynomial_degree
    temp = MKLweSample(-(out.a + out_true.a),
                       encode_message(1, 8) - (out.b + out_true.b))
    ra, rb = _round_mod_switch(temp.a, temp.b, N)
    phase_r = np.asarray(mk_lwe_phase(MKLweSample(ra, rb), lwe_keys))
    phase_pos = np.where(~np.asarray(want), 1.0, -1.0) * (
        phase_r.astype(np.float64) / 2.0**32)
    n_gt, n_lt, classes = _rounded_phase_classes(phase_pos, wrong)
    return NoiseReport(trials, float(fresh.std()), float(np.abs(fresh).max()),
                       float(boot.std()), float(np.abs(boot).max()),
                       int(wrong.size), wrong.tolist()[:16],
                       bk_bytes, ks_bytes, wall,
                       wrong_phase_gt_quarter=n_gt, wrong_phase_lt_zero=n_lt,
                       wrong_classes=classes[:16],
                       boot_noises=boot, fresh_noises=fresh,
                       pre_ks_noise_std=pre_ks_std, pre_ks_noise_max=pre_ks_max)
