"""Frozen parameter dataclasses and the named parameter-set registry.

Port of the reference's parameter layer:
- single-key scheme parameters (3-gen-mk-tfhe/src/api.jl:4-115),
- 3rd-gen multikey parameters (3-gen-mk-tfhe/src/mk_api.jl:32-322),
- the C++ libthfhe gate-bootstrapping parameter set with n = N = 1024
  (src/libthfhe.cpp:316-338).

All parameters are static Python values: they shape traced computations and are
hashable so jitted functions can close over them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
from jax.tree_util import register_static


@dataclass(frozen=True)
class LweParams:
    size: int  # n, the LWE mask length


@dataclass(frozen=True)
class RLweParams:
    polynomial_degree: int  # N, a power of two
    mask_size: int  # k, number of mask polynomials
    bits: int = 32  # torus width: 32 or 64 (reference `is32` flag, rlwe.jl:5)

    @property
    def torus_dtype(self):
        return np.int32 if self.bits == 32 else np.int64


@dataclass(frozen=True)
class TGswParams:
    """Gadget decomposition parameters (3-gen-mk-tfhe/src/tgsw.jl:10-33)."""

    decomp_length: int  # l
    log2_base: int  # log2(B)
    bits: int = 32  # torus width of the decomposed samples

    @property
    def gadget_values(self) -> tuple:
        """1/B^i on the torus, i = 1..l, as python ints (mod 2^bits, signed)."""
        vals = []
        for i in range(1, self.decomp_length + 1):
            shift = self.bits - i * self.log2_base
            v = (1 << shift) if shift >= 0 else 0
            vals.append(_signed(v, self.bits))
        return tuple(vals)

    @property
    def offset(self) -> int:
        """Decomposition offset: B/2 * sum(gadget values) + q/2, wrapped signed.

        The B/2 terms centre each extracted digit in [-B/2, B/2); the final
        q/2 = 2^(bits - l*log2B - 1) turns the truncation of the sub-gadget
        bits into round-to-nearest, so the reconstruction error is centred in
        (-q/2, q/2] instead of the biased -(x mod q) — without it the bias
        accumulates key-coherently across the n CMux steps and dominates the
        bootstrap noise (measured: 20x phase-noise inflation at l*logB=16).
        """
        total = sum((1 << (self.bits - i * self.log2_base)) if self.bits - i * self.log2_base >= 0 else 0
                    for i in range(1, self.decomp_length + 1))
        off = (total * (1 << (self.log2_base - 1))) % (1 << self.bits)
        sub = self.bits - self.decomp_length * self.log2_base
        if sub > 0:
            off = (off + (1 << (sub - 1))) % (1 << self.bits)
        return _signed(off, self.bits)


@dataclass(frozen=True)
class KeyswitchParams:
    decomp_length: int  # t (digits per coefficient)
    log2_base: int  # log2(base)


def _signed(v: int, bits: int) -> int:
    v %= 1 << bits
    return v - (1 << bits) if v >= 1 << (bits - 1) else v


@dataclass(frozen=True)
class SchemeParams:
    """Single-key TFHE scheme parameters (api.jl:4-25 ``SchemeParameters``)."""

    lwe_size: int
    lwe_noise_stddev: float

    rlwe_polynomial_degree: int
    rlwe_mask_size: int
    rlwe_bits: int

    bs_decomp_length: int
    bs_log2_base: int
    bs_noise_stddev: float

    ks_decomp_length: int
    ks_log2_base: int
    ks_noise_stddev: float

    max_parties: int = 1
    # F-block knob: dropped low BODY bytes in the F-block bootstrapping key
    # (BK compression). Sound: the body is rounded at keygen (a
    # deterministic post-hoc degradation of a full-entropy sample; extra
    # noise ~2^(8*drop)/sqrt(12) per coefficient, unamplified). MASK limbs
    # are never dropped (ops/fblock.default_cols). 0 = exact.
    bk_drop_limbs: int = 0
    # WITHDRAWN (r5): quantized-mask BK generation. With the shipped noise
    # (2^-25) far below any useful mask grid, rounding published bodies to
    # the grid cancels the noise exactly and the key falls to linear
    # algebra mod 2 — full key recovery from two BK samples, demonstrated
    # in tests/test_quantized_mask_attack.py. The field remains only so
    # that test can build a vulnerable key; keygen asserts it is 0.
    bk_mask_quantum_bits: int = 0

    @property
    def lwe(self) -> LweParams:
        return LweParams(self.lwe_size)

    @property
    def rlwe(self) -> RLweParams:
        return RLweParams(self.rlwe_polynomial_degree, self.rlwe_mask_size, self.rlwe_bits)

    @property
    def tgsw(self) -> TGswParams:
        return TGswParams(self.bs_decomp_length, self.bs_log2_base, self.rlwe_bits)

    @property
    def ks(self) -> KeyswitchParams:
        return KeyswitchParams(self.ks_decomp_length, self.ks_log2_base)

    @property
    def extracted_lwe(self) -> LweParams:
        """LWE params of samples extracted from RLWE (size = k * N)."""
        return LweParams(self.rlwe_polynomial_degree * self.rlwe_mask_size)


def tfhe_parameters_80(rlwe_mask_size: int = 1) -> SchemeParams:
    """~80-bit security CGGI parameters (api.jl:76-97)."""
    return SchemeParams(
        500, 1 / 2**15 * math.sqrt(2 / math.pi),
        1024, rlwe_mask_size, 32,
        2, 10, 9e-9 * math.sqrt(2 / math.pi),
        8, 2, 1 / 2**15 * math.sqrt(2 / math.pi),
    )


def tfhe_parameters_128(rlwe_mask_size: int = 1) -> SchemeParams:
    """~128-bit security CGGI2019 parameters (api.jl:100-115)."""
    return SchemeParams(
        630, 1 / 2**15,
        1024, rlwe_mask_size, 32,
        3, 7, 1 / 2**25,
        8, 2, 1 / 2**15,
    )


def tfhe_parameters_128_tpu() -> SchemeParams:
    """The 128-bit CGGI set tuned for int8 GEMM throughput: identical crypto
    parameters to tfhe_parameters_128 — the reference's own l=3/Bg=2^7 gadget
    (api.jl:100-115) — with the bootstrapping key's lowest BODY byte rounded
    away at keygen (sound: a deterministic post-hoc rounding of a
    full-entropy sample, extra noise ~2^-25/sqrt(12) per coefficient, at the
    BK noise floor). The mask keeps all four limbs: r4's quantized-mask
    variant (mask on a 2^11 grid) was withdrawn in r5 after an in-repo
    break — sub-grid noise lets an attacker round published bodies to the
    mask grid and recover the key by linear algebra mod 2
    (tests/test_quantized_mask_attack.py). F-block cost: R*cols = 6*7 MAC
    units per CMux step; see the roofline note in docs/MANUAL.md."""
    return SchemeParams(
        630, 1 / 2**15,
        1024, 1, 32,
        3, 7, 1 / 2**25,
        8, 2, 1 / 2**15,
        bk_drop_limbs=1,
    )


def tfhe_parameters_128_tpu_fast() -> SchemeParams:
    """128-bit module-LWE CGGI set with a GEMM-friendly shape: k=2, N=512,
    l=2, Bg=2^8, body rounded to 2^8 (sound, see tfhe_parameters_128_tpu).

    The RLWE layer moves from (k=1, N=1024) to module rank 2 at N=512 —
    the SAME total lattice dimension k*N = 1024 and the same noise 2^-25,
    under the standard module-LWE assumption (Kyber-style; the extracted
    LWE size k*N and the keyswitch are unchanged). Why it is fast on
    int8 matrix hardware: per CMux step the contraction costs (N*R)*(cols*N) MACs with
    R = l*(k+1) and cols = (k+1) limb-columns-ish, i.e. proportional to
    (k*N)^2 * l * ((k+1)/k)^2 — the module split k=1 -> 2 cuts the
    schoolbook-negacyclic MAC count by (4/2.25) = 1.78x at equal security.
    Columns: 2 masks * 4 limbs + body * 3 limbs = 11; R = 6; per-step MAC
    units 11*6 at N=512 vs the sound l=3 set's 7*6 at N=1024 = 2.4x fewer.

    Replaces r5-withdrawn quantized-mask variant (whose 5-column key was
    faster but insecure — tests/test_quantized_mask_attack.py). Reference
    parameter style: 3-gen-mk-tfhe/src/api.jl:76-115.
    """
    return SchemeParams(
        630, 1 / 2**15,
        512, 2, 32,
        2, 8, 1 / 2**25,
        8, 2, 1 / 2**15,
        bk_drop_limbs=1,
    )


def thfhe_parameters_1024() -> SchemeParams:
    """C++ libthfhe parameter set with n = N = 1024 so the LWE key maps 1:1 to a
    degree-1024 TLWE key (src/libthfhe.cpp:316-338; ks 8x2, bk l=3 Bg=2^7)."""
    return SchemeParams(
        1024, 2**-15,
        1024, 1, 32,
        3, 7, 2**-25,
        8, 2, 2**-15,
    )


# Small parameter sets for fast unit tests (not secure; same structure).
def test_parameters(n: int = 16, N: int = 64, bits: int = 32) -> SchemeParams:
    return SchemeParams(
        n, 2**-15,
        N, 1, bits,
        3, 7, 2**-25,
        8, 2, 2**-15,
    )


@dataclass(frozen=True)
class SchemeParams3Gen:
    """3rd-gen (AKO) multikey TFHE parameters (api.jl:52-67 SchemeParameters_3gen)."""

    lwe_size: int
    lwe_noise_stddev: float

    rlwe_polynomial_degree: int
    rlwe_mask_size: int
    rlwe_bits: int

    gsw_decomp_length: int
    gsw_log2_base: int
    gsw_noise_stddev: float

    ks_decomp_length: int
    ks_log2_base: int
    ks_noise_stddev: float

    max_parties: int

    @property
    def lwe(self) -> LweParams:
        return LweParams(self.lwe_size)

    @property
    def rlwe(self) -> RLweParams:
        return RLweParams(self.rlwe_polynomial_degree, self.rlwe_mask_size, self.rlwe_bits)

    @property
    def tgsw(self) -> TGswParams:
        return TGswParams(self.gsw_decomp_length, self.gsw_log2_base, self.rlwe_bits)

    @property
    def ks(self) -> KeyswitchParams:
        return KeyswitchParams(self.ks_decomp_length, self.ks_log2_base)


def mktfhe_parameters_2party_3gen() -> SchemeParams3Gen:
    """mk_api.jl:32-38."""
    return SchemeParams3Gen(520, 2**-13.52, 1024, 1, 64, 2, 7, 2**-30.70, 3, 3, 2**-13.52, 2)


def mktfhe_parameters_4party_3gen() -> SchemeParams3Gen:
    """mk_api.jl:84-90."""
    return SchemeParams3Gen(510, 2**-13.26, 1024, 1, 64, 3, 6, 2**-30.70, 5, 2, 2**-13.26, 4)


def mktfhe_parameters_8party_3gen() -> SchemeParams3Gen:
    """mk_api.jl:140-146 (variant A)."""
    return SchemeParams3Gen(540, 2**-14.04, 1024, 1, 64, 4, 4, 2**-30.70, 5, 2, 2**-14.04, 8)


def mktfhe_parameters_16party_3gen() -> SchemeParams3Gen:
    """mk_api.jl:214-220."""
    return SchemeParams3Gen(590, 2**-15.34, 2048, 1, 64, 1, 26, 2**-62.0, 4, 3, 2**-15.34, 16)


def mktfhe_parameters_3party_3gen() -> SchemeParams3Gen:
    """mk_api.jl:44-50."""
    return SchemeParams3Gen(510, 2**-13.26, 1024, 1, 64, 2, 7, 2**-30.70, 5, 2, 2**-13.26, 3)


def mktfhe_parameters_32party_3gen() -> SchemeParams3Gen:
    """mk_api.jl:246-252."""
    return SchemeParams3Gen(620, 2**-16.12, 2048, 1, 64, 1, 26, 2**-62.0, 4, 3, 2**-16.12, 32)


def mktfhe_parameters_32party_3gen_for_fft() -> SchemeParams3Gen:
    """9-sigma FFT-headroom variant (mk_api.jl:254-261)."""
    return SchemeParams3Gen(680, 2**-17.68, 2048, 1, 64, 1, 25, 2**-62.0, 5, 3, 2**-17.68, 32)


def mktfhe_parameters_64party_3gen() -> SchemeParams3Gen:
    """mk_api.jl:268-274."""
    return SchemeParams3Gen(650, 2**-16.90, 2048, 1, 64, 1, 25, 2**-62.0, 4, 3, 2**-16.90, 64)


def mktfhe_parameters_64party_3gen_for_fft() -> SchemeParams3Gen:
    """9-sigma FFT-headroom variant (mk_api.jl:276-283)."""
    return SchemeParams3Gen(720, 2**-18.72, 4096, 1, 64, 1, 27, 2**-62.0, 5, 3, 2**-18.72, 64)


def mktfhe_parameters_128party_3gen() -> SchemeParams3Gen:
    """mk_api.jl:292-298."""
    return SchemeParams3Gen(670, 2**-17.42, 2048, 1, 64, 1, 24, 2**-62.0, 5, 3, 2**-17.42, 128)


def mktfhe_parameters_256party_3gen() -> SchemeParams3Gen:
    """mk_api.jl:304-310."""
    return SchemeParams3Gen(740, 2**-19.24, 2048, 1, 64, 2, 18, 2**-62.0, 8, 2, 2**-19.24, 256)


def mktfhe_parameters_512party_3gen() -> SchemeParams3Gen:
    """mk_api.jl:316-322."""
    return SchemeParams3Gen(730, 2**-18.98, 4096, 1, 64, 1, 27, 2**-62.0, 5, 3, 2**-18.98, 512)


def test_parameters_3gen(parties: int = 2, n: int = 16, N: int = 64) -> SchemeParams3Gen:
    """Tiny insecure 3gen parameter set for unit tests."""
    return SchemeParams3Gen(n, 2**-13.52, N, 1, 64, 2, 7, 2**-30.70, 3, 3, 2**-13.52, parties)


@dataclass(frozen=True)
class SchemeParamsCCS:
    """1st-gen (CCS) multikey TFHE parameters (api.jl:4-25 ``SchemeParameters``
    as used by the mktfhe_parameters_{2,4,8,16}party sets, mk_api.jl:4-220)."""

    lwe_size: int
    lwe_noise_stddev: float

    rlwe_polynomial_degree: int
    rlwe_mask_size: int
    rlwe_bits: int

    bs_decomp_length: int
    bs_log2_base: int
    bs_noise_stddev: float

    ks_decomp_length: int
    ks_log2_base: int
    ks_noise_stddev: float

    max_parties: int

    @property
    def lwe(self) -> LweParams:
        return LweParams(self.lwe_size)

    @property
    def rlwe(self) -> RLweParams:
        return RLweParams(self.rlwe_polynomial_degree, self.rlwe_mask_size, self.rlwe_bits)

    @property
    def tgsw(self) -> TGswParams:
        return TGswParams(self.bs_decomp_length, self.bs_log2_base, self.rlwe_bits)

    @property
    def ks(self) -> KeyswitchParams:
        return KeyswitchParams(self.ks_decomp_length, self.ks_log2_base)


def mktfhe_parameters_2party_ccs() -> SchemeParamsCCS:
    """mk_api.jl:4-10 (mktfhe_parameters_2party)."""
    return SchemeParamsCCS(560, 3.05e-5, 1024, 1, 32, 3, 9, 3.72e-9, 8, 2, 3.05e-5, 2)


def mktfhe_parameters_4party_ccs() -> SchemeParamsCCS:
    """mk_api.jl:56-62 (mktfhe_parameters_4party)."""
    return SchemeParamsCCS(560, 3.05e-5, 1024, 1, 32, 4, 8, 3.72e-9, 8, 2, 3.05e-5, 4)


def mktfhe_parameters_8party_ccs() -> SchemeParamsCCS:
    """mk_api.jl:110-116 (mktfhe_parameters_8party)."""
    return SchemeParamsCCS(560, 3.05e-5, 1024, 1, 32, 5, 6, 3.72e-9, 8, 2, 3.05e-5, 8)


def mktfhe_parameters_16party_ccs() -> SchemeParamsCCS:
    """mk_api.jl:183-190 (mktfhe_parameters_16party)."""
    return SchemeParamsCCS(560, 3.05e-5, 1024, 1, 32, 12, 2, 3.72e-9, 8, 2, 3.05e-5, 16)


def test_parameters_ccs(parties: int = 2, n: int = 16, N: int = 64) -> SchemeParamsCCS:
    """Tiny insecure CCS parameter set for unit tests."""
    return SchemeParamsCCS(n, 3.05e-5, N, 1, 32, 3, 9, 3.72e-9, 8, 2, 3.05e-5, parties)


@dataclass(frozen=True)
class SchemeParamsKMS:
    """2nd-gen (KMS) multikey TFHE parameters (api.jl:27-50
    ``SchemeParameters_new``; sets mktfhe_parameters_{2..16}party_new/_fast,
    mk_api.jl:12-30, 64-82, 118-136, 195-212)."""

    lwe_size: int
    lwe_noise_stddev: float

    rlwe_polynomial_degree: int
    rlwe_mask_size: int
    rlwe_bits: int  # reference is32=false => 64

    gsw_decomp_length: int
    gsw_log2_base: int
    gsw_noise_stddev: float

    lev_decomp_length: int
    lev_log2_base: int

    uni_decomp_length: int
    uni_log2_base: int
    uni_noise_stddev: float

    ks_decomp_length: int
    ks_log2_base: int
    ks_noise_stddev: float

    max_parties: int

    @property
    def lwe(self) -> LweParams:
        return LweParams(self.lwe_size)

    @property
    def rlwe(self) -> RLweParams:
        return RLweParams(self.rlwe_polynomial_degree, self.rlwe_mask_size, self.rlwe_bits)

    @property
    def tgsw(self) -> TGswParams:
        """Per-party single-key GSW gadget (gsw_key of BootstrapKeyPart_new)."""
        return TGswParams(self.gsw_decomp_length, self.gsw_log2_base, self.rlwe_bits)

    @property
    def tlev(self) -> TGswParams:
        """TLev accumulator gadget."""
        return TGswParams(self.lev_decomp_length, self.lev_log2_base, self.rlwe_bits)

    @property
    def uni(self) -> TGswParams:
        """Uni-encryption (relinearisation key) gadget."""
        return TGswParams(self.uni_decomp_length, self.uni_log2_base, self.rlwe_bits)

    @property
    def ks(self) -> KeyswitchParams:
        return KeyswitchParams(self.ks_decomp_length, self.ks_log2_base)


def mktfhe_parameters_2party_kms(fast: bool = False) -> SchemeParamsKMS:
    """mk_api.jl:12-30 (mktfhe_parameters_2party_new / _fast)."""
    uni = (3, 10) if fast else (2, 13)
    return SchemeParamsKMS(560, 3.05e-5, 2048, 1, 64, 3, 13, 4.63e-18,
                           2, 7, uni[0], uni[1], 4.63e-18, 8, 2, 3.05e-5, 2)


def mktfhe_parameters_4party_kms(fast: bool = False) -> SchemeParamsKMS:
    """mk_api.jl:64-82 (mktfhe_parameters_4party_new / _fast)."""
    uni = (7, 6) if fast else (5, 8)
    return SchemeParamsKMS(560, 3.05e-5, 2048, 1, 64, 5, 8, 4.63e-18,
                           2, 8, uni[0], uni[1], 4.63e-18, 8, 2, 3.05e-5, 4)


def mktfhe_parameters_8party_kms(fast: bool = False) -> SchemeParamsKMS:
    """mk_api.jl:118-136 (mktfhe_parameters_8party_new / _fast)."""
    uni = (7, 4) if fast else (8, 4)
    return SchemeParamsKMS(560, 3.05e-5, 2048, 1, 64, 4, 11, 4.63e-18,
                           3, 6, uni[0], uni[1], 4.63e-18, 8, 2, 3.05e-5, 8)


def mktfhe_parameters_16party_kms(fast: bool = False) -> SchemeParamsKMS:
    """mk_api.jl:192-210 (mktfhe_parameters_16party_new / _fast)."""
    uni = (7, 4) if fast else (9, 4)
    return SchemeParamsKMS(560, 3.05e-5, 2048, 1, 64, 5, 9, 4.63e-18,
                           3, 6, uni[0], uni[1], 4.63e-18, 8, 2, 3.05e-5, 16)


def mktfhe_parameters_32party_kms(fast: bool = False) -> SchemeParamsKMS:
    """mk_api.jl:226-243 (mktfhe_parameters_32party_new / _fast; the two are
    identical in the reference)."""
    return SchemeParamsKMS(560, 3.05e-5, 2048, 1, 64, 6, 8, 4.63e-18,
                           3, 7, 16, 2, 4.63e-18, 8, 2, 3.05e-5, 32)


def test_parameters_kms(parties: int = 2, n: int = 16, N: int = 64) -> SchemeParamsKMS:
    """Tiny insecure KMS parameter set for unit tests (64-bit torus like the
    shipped sets, small ring)."""
    return SchemeParamsKMS(n, 3.05e-5, N, 1, 64, 3, 13, 4.63e-18,
                           2, 7, 2, 13, 4.63e-18, 8, 2, 3.05e-5, parties)


# Parameter dataclasses are hashable static metadata: registering them as
# static pytree nodes lets keys/ciphertexts that carry them flow through
# jit/pjit/shard_map without tracing them as arrays.
for _cls in (LweParams, RLweParams, TGswParams, KeyswitchParams,
             SchemeParams, SchemeParams3Gen, SchemeParamsCCS, SchemeParamsKMS):
    register_static(_cls)


PARAMETER_REGISTRY = {
    "tfhe_80": tfhe_parameters_80,
    "tfhe_128": tfhe_parameters_128,
    "tfhe_128_tpu": tfhe_parameters_128_tpu,
    "tfhe_128_tpu_fast": tfhe_parameters_128_tpu_fast,
    "thfhe_1024": thfhe_parameters_1024,
    "tfhe_test_small": test_parameters,  # INSECURE; CI / CLI smoke only
    "mk_2party_3gen": mktfhe_parameters_2party_3gen,
    "mk_3party_3gen": mktfhe_parameters_3party_3gen,
    "mk_4party_3gen": mktfhe_parameters_4party_3gen,
    "mk_8party_3gen": mktfhe_parameters_8party_3gen,
    "mk_16party_3gen": mktfhe_parameters_16party_3gen,
    "mk_32party_3gen": mktfhe_parameters_32party_3gen,
    "mk_32party_3gen_for_fft": mktfhe_parameters_32party_3gen_for_fft,
    "mk_64party_3gen": mktfhe_parameters_64party_3gen,
    "mk_64party_3gen_for_fft": mktfhe_parameters_64party_3gen_for_fft,
    "mk_128party_3gen": mktfhe_parameters_128party_3gen,
    "mk_256party_3gen": mktfhe_parameters_256party_3gen,
    "mk_512party_3gen": mktfhe_parameters_512party_3gen,
    "mk_2party_ccs": mktfhe_parameters_2party_ccs,
    "mk_4party_ccs": mktfhe_parameters_4party_ccs,
    "mk_8party_ccs": mktfhe_parameters_8party_ccs,
    "mk_16party_ccs": mktfhe_parameters_16party_ccs,
    "mk_2party_kms": mktfhe_parameters_2party_kms,
    "mk_4party_kms": mktfhe_parameters_4party_kms,
    "mk_8party_kms": mktfhe_parameters_8party_kms,
    "mk_16party_kms": mktfhe_parameters_16party_kms,
    "mk_32party_kms": mktfhe_parameters_32party_kms,
}
