"""Multikey encrypted K-nearest-neighbours with the threshold-decryption tail.

The k-party application E2E the reference implies but never assembles in one
program: the encrypted-KNN circuit of src/KNN_medical_data.cpp (distances
:161-263, sort :362-489, majority vote + threshold compare :650-760) evaluated
over 3rd-gen MULTIKEY ciphertexts (mk/gates3gen word circuits — every party
contributes its own key, the cloud computes under the concatenated key), and
the reference's E2E tail `ciphertext_conversion_threshold_decryption`
(src/KNN_medical_data.cpp:531-572): the decision bit goes through LWE→TLWE
conversion and Benaloh–Leichter (3,5)-threshold decryption with party subset
{1,2,4} over a smudging-bound sweep.

For the multikey tail the (parties, n) mask flattens into ONE LWE ciphertext
under the concatenated party key (phase is identical by construction:
b − Σ_p <a_p, s_p> = b − <a_flat, s_cat>), which then embeds into a
degree-(parties·n) ring ciphertext exactly like the reference's
TLweFromLwe (src/Convert.cpp:12-19) — the ring degree need not be a power of
two for the exact negacyclic products in threshold/decrypt.py.

Batch-first as everywhere: all train rows / columns / bit positions of a
circuit stage ride one multikey bootstrap call (the reference's
`#pragma omp parallel for` over train rows, :681, is the batch axis).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..lwe import LweKey, LweSample
from ..mk import gates3gen as g3
from ..mk.keys3gen import MKCloudKey, MKSecretKey, mk_fb_supported
from ..mk.samples import MKLweSample, mk_decrypt, mk_int_encrypt
from ..threshold.convert import tlwe_from_lwe
from ..threshold.decrypt import threshold_decrypt
from ..threshold.shares import share_secret_streaming
from .knn import load_cardio_csv


def mk_abs_difference(ck: MKCloudKey, a: MKLweSample, b: MKLweSample,
                      width: int) -> MKLweSample:
    """|a - b| (distance, KNN_medical_data.cpp:217-236): both subtraction
    directions batch into ONE circuit via an extra axis, then the sign bit of
    a-b selects."""
    both_a = MKLweSample(jnp.stack([a.a, b.a], 1), jnp.stack([a.b, b.b], 1))
    both_b = MKLweSample(jnp.stack([b.a, a.a], 1), jnp.stack([b.b, a.b], 1))
    d = g3.mk_subtract(ck, both_a, both_b, width)  # (width, 2, ...)
    d1 = MKLweSample(d.a[:, 0], d.b[:, 0])  # a - b
    d2 = MKLweSample(d.a[:, 1], d.b[:, 1])  # b - a
    sign = g3._bit(d1, width - 1)
    return g3.mk_mux_word(ck, sign, d2, d1)


def mk_manhattan_distance(ck: MKCloudKey, row1: MKLweSample, row2: MKLweSample,
                          width: int) -> MKLweSample:
    """Σ_cols |row1_c - row2_c| (distance_bw_data, KNN_medical_data.cpp:239-263)
    with a tree reduction over the column axis (axis -3 behind (parties, n))."""
    diffs = mk_abs_difference(ck, row1, row2, width)  # (width, ..., cols, P, n)
    cols = diffs.b.shape[-1]
    terms = [MKLweSample(diffs.a[..., c, :, :], diffs.b[..., c])
             for c in range(cols)]
    while len(terms) > 1:
        nxt = []
        for i in range(0, len(terms) - 1, 2):
            zero = g3.mk_word_constant(ck, terms[i], False)
            nxt.append(g3.mk_add(ck, terms[i], terms[i + 1], zero, width))
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def mk_knn_predict(ck: MKCloudKey, train_rows: MKLweSample,
                   train_labels: MKLweSample, test_row: MKLweSample,
                   k: int, width: int) -> MKLweSample:
    """Multikey encrypted KNN decision bit (inputDataSet,
    KNN_medical_data.cpp:576-776): batched distances against all train rows,
    bubble-sort by distance with labels as payload, majority vote of the k
    nearest through ripple adders, threshold compare (count > k/2).

    train_rows: (width, rows, cols, parties, n); train_labels:
    (1, rows, parties, n); test_row: (width, cols, parties, n).
    """
    n_rows = train_rows.b.shape[1]
    test = MKLweSample(
        jnp.broadcast_to(test_row.a[:, None], train_rows.a.shape),
        jnp.broadcast_to(test_row.b[:, None], train_rows.b.shape))
    dists = mk_manhattan_distance(ck, train_rows, test, width)  # (width, rows, P, n)

    dist_words = [MKLweSample(dists.a[:, r], dists.b[:, r])
                  for r in range(n_rows)]
    label_words = [MKLweSample(train_labels.a[:, r], train_labels.b[:, r])
                   for r in range(n_rows)]
    _, (sorted_labels,) = g3.mk_bubble_sort(ck, dist_words, width,
                                            [label_words])

    cnt_width = max(2, k.bit_length() + 1)
    # the zero bit must carry the label words' trailing batch axes (e.g. the
    # batched-test-rows axis) so _stack_bits shapes align
    zero_bit = g3.mk_gate_constant(
        ck, jnp.zeros(sorted_labels[0].b.shape[1:], bool))

    def widen(bit_word: MKLweSample) -> MKLweSample:
        pads = [g3._bit(bit_word, 0)] + [zero_bit] * (cnt_width - 1)
        return g3._stack_bits(pads)

    count = widen(sorted_labels[0])
    for i in range(1, k):
        count = g3.mk_add(ck, count, widen(sorted_labels[i]), zero_bit,
                          cnt_width)

    # predict 1 iff count > k/2  <=>  NOT(count < floor(k/2)+1)
    thresh_bits = jnp.array([(k // 2 + 1) >> i & 1
                             for i in range(cnt_width)]) == 1
    thresh_bits = jnp.broadcast_to(
        thresh_bits.reshape((cnt_width,) + (1,) * (count.b.ndim - 1)),
        count.b.shape)
    thresh = g3.mk_gate_constant(ck, thresh_bits)
    less = g3._bit(g3.mk_subtract(ck, count, thresh, cnt_width), cnt_width - 1)
    return g3.mk_gate_not(ck, less)


def mk_flatten(x: MKLweSample) -> LweSample:
    """An MK ciphertext IS one LWE ciphertext under the concatenated party
    key: flatten the (parties, n) mask (phase-identical by construction)."""
    return LweSample(x.a.reshape(x.a.shape[:-2] + (-1,)), x.b)


def concat_lwe_key(lwe_keys: Sequence[LweKey]) -> LweKey:
    return LweKey(jnp.concatenate([k.key for k in lwe_keys]))


def mk_threshold_tail(decision: MKLweSample, lwe_keys: Sequence[LweKey],
                      rng_key, t: int = 3, p: int = 5,
                      subset: Sequence[int] = (1, 2, 4),
                      bound_start: float = 0.0125,
                      bound_stop: float = 1e-3) -> list[dict]:
    """The reference's E2E tail on the multikey decision bit
    (ciphertext_conversion_threshold_decryption,
    src/KNN_medical_data.cpp:531-572): LWE→TLWE embed, (3,5) Benaloh–Leichter
    sharing of the joint ring key, threshold decryption with subset {1,2,4}
    across the smudging-bound sweep 0.0125 → 1e-3 (halving), sign-decoding
    coefficient 0 at each bound.

    Runs on the HOST CPU backend: threshold decryption is the client-side
    (party-side) stage of the pipeline — only gate evaluation is the cloud's
    device work — and its exact int64 ring products are host math."""
    from ..utils.device import on_host

    with on_host():
        lwe = mk_flatten(jax.device_get(decision))
        ring = tlwe_from_lwe(lwe)
        key_cat = jnp.concatenate([jnp.asarray(jax.device_get(k.key))
                                   for k in lwe_keys])
        repo = share_secret_streaming(key_cat.reshape(1, -1).astype(jnp.int32),
                                      t, p, jax.random.fold_in(rng_key, 0))
        results = []
        bound = bound_start
        i = 1
        while bound > bound_stop:
            plain = threshold_decrypt(ring, repo, list(subset), bound,
                                      jax.random.fold_in(rng_key, i))
            bit = int(np.asarray(jax.device_get(plain)).reshape(-1)[0] > 0)
            results.append({"bound": bound, "bit": bit})
            bound /= 2
            i += 1
    return results


def mk_encrypt_dataset(key, lwe_keys, features: np.ndarray, labels: np.ndarray,
                       width: int, params):
    """Bitwise multikey encryption of an integer feature matrix + label bits
    (mk_int_encrypt_3gen, mk_api.jl:576-589, over the whole dataset)."""
    feats = mk_int_encrypt(key, lwe_keys, jnp.asarray(features), width, params)
    labs = mk_int_encrypt(jax.random.fold_in(key, 1), lwe_keys,
                          jnp.asarray(labels), 1, params)
    return feats, labs


def plaintext_oracle(tr_f: np.ndarray, tr_l: np.ndarray, te_f: np.ndarray,
                     k: int, width: int) -> list[int]:
    """Bit-level oracle of the encrypted circuit: Manhattan distances mod
    2^width, the exact bubble-sort compare-swap semantics (strict less-than:
    ties do swap), majority over the first k labels."""
    preds = []
    mask = (1 << width) - 1

    def circuit_abs(a: int, b: int) -> int:
        # the circuit's |a-b|: masked differences + sign-bit select
        d1 = (a - b) & mask
        d2 = (b - a) & mask
        return d2 if (d1 >> (width - 1)) & 1 else d1

    for row in te_f:
        d = []
        for r in range(tr_f.shape[0]):
            s = 0
            for c in range(tr_f.shape[1]):
                s = (s + circuit_abs(int(tr_f[r, c]), int(row[c]))) & mask
            d.append(s)
        pairs = [(d[i], int(tr_l[i])) for i in range(len(d))]
        m = len(pairs)
        for i in range(m - 1):
            for j in range(m - 1 - i):
                # circuit: a_less = sign bit of (a - b); swap unless a < b
                a, b = pairs[j][0], pairs[j + 1][0]
                a_less = ((a - b) & mask) >> (width - 1) & 1
                if not a_less:
                    pairs[j], pairs[j + 1] = pairs[j + 1], pairs[j]
        count = sum(lbl for _, lbl in pairs[:k])
        preds.append(int(count > k // 2))
    return preds


def run_mk_pipeline(key, params, parties: int, csv_path: str, k: int = 5,
                    width: int = 8, train_rows: int = 5, test_rows: int = 1,
                    feature_cols=None, scale_shift: int = 0,
                    forms=None, threshold_tail: bool = True,
                    progress=None, batch_tests: bool = True) -> dict:
    """k-party encrypted-KNN E2E (BASELINE configs[4]): per-party keygen,
    multikey cloud keygen, multikey encryption of the cardio rows, encrypted
    prediction per test row, multikey decryption + accuracy tally
    (KNN_medical_data.cpp:738-748), and the threshold-decryption tail on the
    final decision bit (:750 → :531-572).

    ``batch_tests``: carry all test rows as one batch axis, which amortises
    circuit depth; False runs the rows one at a time."""
    from ..mk.keys3gen import (mk_cloud_keygen, mk_fb_geometry,
                               mk_fb_stream_supported, mk_party_keygen)

    if forms is None:
        # size-aware fast-form pick (mirrors benchmarks/perf_comp.py): the
        # expanded F-block at >=4-party registry sets exceeds HBM (25.7 GB
        # at 4 parties) — use the streamed compact key there
        if mk_fb_supported(params):
            g = mk_fb_geometry(params, parties)
            fb_bytes = g.n * g.D * g.R * g.bs * len(g.cols) * g.bs
            forms = ("fblock",) if fb_bytes <= 10 * 2**30 else ("fbstream",)
        elif mk_fb_stream_supported(params):
            forms = ("fbstream",)  # wide-digit gadget: exact 64-bit streamed
        else:
            forms = ("conv",)
    sks = [mk_party_keygen(jax.random.fold_in(key, 100 + p), params)
           for p in range(parties)]
    ck = mk_cloud_keygen(jax.random.fold_in(key, 7), sks, params, forms=forms)
    lwe_keys = [sk.lwe for sk in sks]

    tr_f, tr_l, te_f, te_l = load_cardio_csv(csv_path, train_rows, test_rows,
                                             feature_cols)
    tr_f = tr_f >> scale_shift
    te_f = te_f >> scale_shift
    feats, labs = mk_encrypt_dataset(jax.random.fold_in(key, 2), lwe_keys,
                                     tr_f, tr_l, width, params)

    predictions, tails = [], []
    if batch_tests:
        # all test rows ride the circuit as ONE extra batch axis: every gate
        # bootstrap carries T x (rows x cols x bits) gates, amortising the
        # sequential circuit depth across test rows
        T = te_f.shape[0]
        test_word = mk_int_encrypt(jax.random.fold_in(key, 50), lwe_keys,
                                   jnp.asarray(te_f), width, params)
        # test_word: (width, T, cols, P, n); the T axis slots in AFTER the
        # train-row axis of the (broadcast) feature/label words, so
        # mk_knn_predict's row indexing at axis 1 is unchanged and T rides
        # as a plain trailing batch axis
        feats_b = MKLweSample(
            jnp.broadcast_to(feats.a[:, :, None],
                             feats.a.shape[:2] + (T,) + feats.a.shape[2:]),
            jnp.broadcast_to(feats.b[:, :, None],
                             feats.b.shape[:2] + (T,) + feats.b.shape[2:]))
        labs_b = MKLweSample(
            jnp.broadcast_to(labs.a[:, :, None],
                             labs.a.shape[:2] + (T,) + labs.a.shape[2:]),
            jnp.broadcast_to(labs.b[:, :, None],
                             labs.b.shape[:2] + (T,) + labs.b.shape[2:]))
        decision = mk_knn_predict(ck, feats_b, labs_b, test_word, k, width)
        decision.b.block_until_ready()
        dec_bits = np.asarray(jax.device_get(
            mk_decrypt(lwe_keys, decision))).reshape(-1)
        predictions = [int(b) for b in dec_bits]
        for i in range(te_f.shape[0]):
            if threshold_tail:
                row_dec = MKLweSample(decision.a[i], decision.b[i])
                tails.append(mk_threshold_tail(
                    row_dec, lwe_keys, jax.random.fold_in(key, 90 + i)))
            if progress is not None:
                progress(i, predictions[i])
    else:
        for i in range(te_f.shape[0]):
            test_word = mk_int_encrypt(jax.random.fold_in(key, 50 + i),
                                       lwe_keys, jnp.asarray(te_f[i]), width,
                                       params)
            decision = mk_knn_predict(ck, feats, labs, test_word, k, width)
            decision.b.block_until_ready()
            predictions.append(int(np.asarray(jax.device_get(
                mk_decrypt(lwe_keys, decision)))))
            if threshold_tail:
                tails.append(mk_threshold_tail(
                    decision, lwe_keys, jax.random.fold_in(key, 90 + i)))
            if progress is not None:
                progress(i, predictions[-1])

    oracle = plaintext_oracle(tr_f, tr_l, te_f, k, width)
    correct = sum(int(p == int(t)) for p, t in zip(predictions, te_l))
    return {"predictions": predictions, "labels": te_l.tolist(),
            "oracle": oracle, "matches_oracle": predictions == oracle,
            "correct": correct, "total": len(predictions),
            "accuracy": correct / max(1, len(predictions)),
            "threshold_tail": tails, "parties": parties, "k": k,
            "width": width}
