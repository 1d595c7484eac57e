"""Encrypted K-nearest-neighbours over homomorphic integer words.

Rework of src/KNN_medical_data.cpp: bitwise-encrypt feature rows,
Manhattan distance per train row (|a-b| via two differences + sign-select MUX,
:161-263), bubble-sort rows by distance with labels as payload (:362-489),
majority vote of the K nearest labels through ripple adders and a threshold
compare (:650-760). The reference's `#pragma omp parallel for` over train rows
(:681) becomes the batch axis: ALL train-row distances compute in one batched
gate program.

(The reference selects the absolute value with the LSB of the difference
(:229, `difference1[0]`); the sign lives in the top bit, so we select on
bit width-1 — behaviour-correct Manhattan distance rather than a faithful
reproduction of that slip.)
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..boot import gates
from ..boot.api import CloudKey, SecretKey, encrypt
from ..circuits import words
from ..lwe import LweSample


def abs_difference(ck: CloudKey, a: LweSample, b: LweSample, width: int) -> LweSample:
    """|a - b| = (a-b) < 0 ? (b-a) : (a-b)  (distance, KNN_medical_data.cpp:217-236)."""
    d1 = words.subtract(ck, a, b, width)  # a - b, top bit = sign
    d2 = words.subtract(ck, b, a, width)
    sign = words.bit(d1, width - 1)
    return words.mux_word(ck, sign, d2, d1, width)


def manhattan_distance(ck: CloudKey, row1: LweSample, row2: LweSample,
                       width: int) -> LweSample:
    """Σ_cols |row1_c - row2_c| (distance_bw_data, KNN_medical_data.cpp:239-263).

    rows: bit-axis words with a trailing column axis (width, ..., cols, n);
    the per-column |diff| runs as ONE batched circuit over all columns (and
    any extra leading batch axes), then a sequential tree sum over columns.
    """
    diffs = abs_difference(ck, row1, row2, width)  # (width, ..., cols)
    cols = diffs.b.shape[-1]
    terms = [LweSample(diffs.a[..., c, :], diffs.b[..., c]) for c in range(cols)]
    # tree reduction halves the sequential adder depth vs the reference's
    # linear accumulation
    while len(terms) > 1:
        nxt = []
        for i in range(0, len(terms) - 1, 2):
            zero = gates.gate_constant(ck, jnp.zeros(terms[i].b.shape[1:], bool))
            nxt.append(words.add(ck, terms[i], terms[i + 1], zero, width))
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def knn_predict(ck: CloudKey, train_rows: LweSample, train_labels: LweSample,
                test_row: LweSample, k: int, width: int) -> LweSample:
    """Encrypted KNN decision bit (inputDataSet, KNN_medical_data.cpp:576-776).

    train_rows: (width, rows, cols, n) encrypted feature words;
    train_labels: (1, rows, n) encrypted label bits; test_row: (width, cols, n).
    Returns one encrypted bit: majority label among the k nearest.
    """
    n_rows = train_rows.b.shape[1]
    # broadcast the test row against all train rows: ONE batched distance
    test = LweSample(jnp.broadcast_to(test_row.a[:, None], train_rows.a.shape),
                     jnp.broadcast_to(test_row.b[:, None], train_rows.b.shape))
    dists = manhattan_distance(ck, train_rows, test, width)  # (width, rows)

    dist_words = [LweSample(dists.a[:, r], dists.b[:, r]) for r in range(n_rows)]
    label_words = [LweSample(train_labels.a[:, r], train_labels.b[:, r])
                   for r in range(n_rows)]
    _, (sorted_labels,) = words.bubble_sort(ck, dist_words, width, [label_words])

    # majority vote: count the k nearest labels with ripple adders
    cnt_width = max(2, k.bit_length() + 1)
    zero_bit = gates.gate_constant(ck, jnp.zeros((), bool))

    def widen(bit_word):
        pads = [words.bit(bit_word, 0)] + [zero_bit] * (cnt_width - 1)
        return words.stack_bits(pads)

    count = widen(sorted_labels[0])
    for i in range(1, k):
        count = words.add(ck, count, widen(sorted_labels[i]), zero_bit, cnt_width)

    # predict 1 iff count > k/2  <=>  count >= floor(k/2)+1  <=>  NOT(count < t)
    thresh_bits = jnp.array([(k // 2 + 1) >> i & 1 for i in range(cnt_width)]) == 1
    thresh = gates.gate_constant(ck, thresh_bits)
    less = words.less_than(ck, count, thresh, cnt_width)
    return gates.gate_not(ck, less)


def threshold_tail(decision: LweSample, sk: SecretKey, rng_key, t: int = 3,
                   p: int = 5, subset=(1, 2, 4), bound_start: float = 0.0125,
                   bound_stop: float = 1e-3) -> list[dict]:
    """The reference's application tail
    (ciphertext_conversion_threshold_decryption,
    src/KNN_medical_data.cpp:531-572): embed the decision bit into ring-LWE
    (TLweFromLwe), Benaloh–Leichter (3,5)-share the ring key, and
    threshold-decrypt with party subset {1,2,4} across the smudging-bound
    sweep 0.0125 → 1e-3 (halving), sign-decoding coefficient 0.

    Runs on the HOST CPU backend: threshold decryption is the client-side
    stage (the cloud's device work ends at the gate evaluation), and its
    exact int64 ring products are host math."""
    from ..threshold.convert import tlwe_from_lwe
    from ..threshold.decrypt import threshold_decrypt
    from ..threshold.shares import share_secret_streaming
    from ..utils.device import on_host

    with on_host():
        ring = tlwe_from_lwe(LweSample(*jax.device_get(tuple(decision))))
        key_poly = jnp.asarray(jax.device_get(sk.key.key)).reshape(
            1, -1).astype(jnp.int32)
        repo = share_secret_streaming(key_poly, t, p,
                                      jax.random.fold_in(rng_key, 0))
        results = []
        bound, i = bound_start, 1
        while bound > bound_stop:
            plain = threshold_decrypt(ring, repo, list(subset), bound,
                                      jax.random.fold_in(rng_key, i))
            bit = int(np.asarray(jax.device_get(plain)).reshape(-1)[0] > 0)
            results.append({"bound": bound, "bit": bit})
            bound /= 2
            i += 1
    return results


def encrypt_dataset(key, sk: SecretKey, features: np.ndarray, labels: np.ndarray,
                    width: int):
    """Bitwise-encrypt an integer feature matrix (rows, cols) and label bits."""
    feats = words.int_encrypt(key, sk, jnp.asarray(features), width)
    labs = words.int_encrypt(jax.random.fold_in(key, 1), sk,
                             jnp.asarray(labels), 1)
    return feats, labs


def load_cardio_csv(path: str, train_rows: int = 5, test_rows: int = 1,
                    feature_cols=None, label_col: int = -1):
    """Parse the cardio CSV of KNN_medical_data (inputDataSet,
    src/KNN_medical_data.cpp:582-647): a header line then integer rows
    (floats truncate like the reference's ``ss >> x``). Column 0 is an id and
    the last column the label by default. Returns (train_features,
    train_labels, test_features, test_labels) int arrays.
    """
    rows = []
    with open(path) as f:
        header = f.readline()
        for line in f:
            line = line.strip()
            if not line:
                continue
            rows.append([int(float(w)) for w in line.split(",")])
            if len(rows) == train_rows + test_rows:
                break
    data = np.asarray(rows, np.int64)
    if feature_cols is None:
        feature_cols = list(range(1, data.shape[1] - 1))
    feats = data[:, feature_cols]
    labels = data[:, label_col]
    return (feats[:train_rows], labels[:train_rows],
            feats[train_rows:], labels[train_rows:])


def run_pipeline(key, sk: SecretKey, ck: CloudKey, csv_path: str, k: int = 5,
                 width: int = 8, train_rows: int = 5, test_rows: int = 1,
                 feature_cols=None, scale_shift: int = 0,
                 jit_predict: bool = False,
                 with_threshold_tail: bool = False) -> dict:
    """End-to-end encrypted-KNN accuracy pipeline
    (src/KNN_medical_data.cpp:818-851 + accuracy tally :738-748): load the
    CSV, encrypt train+test rows, predict every test row homomorphically,
    decrypt, and tally accuracy against the plaintext labels.

    ``scale_shift`` right-shifts features so max distances fit in ``width``
    bits (the reference uses 32-bit words; small widths need coarser data).
    """
    tr_f, tr_l, te_f, te_l = load_cardio_csv(csv_path, train_rows, test_rows,
                                             feature_cols)
    tr_f = tr_f >> scale_shift
    te_f = te_f >> scale_shift
    feats, labs = encrypt_dataset(key, sk, tr_f, tr_l, width)
    # ``jit_predict``: compile the WHOLE prediction circuit as one XLA
    # program. Upfront compile is large, but per-row evaluation is fast and
    # it sidesteps an XLA:CPU crash seen when the eager path accumulates
    # hundreds of separate compilations at larger widths.
    predict = (jax.jit(lambda c, f, l, t: knn_predict(c, f, l, t, k, width))
               if jit_predict else
               (lambda c, f, l, t: knn_predict(c, f, l, t, k, width)))
    predictions, tails = [], []
    for i in range(te_f.shape[0]):
        if i and not jit_predict:
            # the eager path compiles hundreds of distinct XLA programs;
            # letting them accumulate across test rows has crashed the CPU
            # client (see tests/conftest.py) — drop them per row
            jax.clear_caches()
        test_word = words.int_encrypt(jax.random.fold_in(key, 50 + i), sk,
                                      jnp.asarray(te_f[i]), width)
        decision = predict(ck, feats, labs, test_word)
        from ..boot import api as _api

        predictions.append(int(np.asarray(_api.decrypt(sk, decision))))
        if with_threshold_tail:
            # the reference runs the (3,5)-threshold tail per test row
            # (KNN_medical_data.cpp:750)
            tails.append(threshold_tail(decision, sk,
                                        jax.random.fold_in(key, 90 + i)))
    correct = sum(int(p == int(t)) for p, t in zip(predictions, te_l))
    out = {"predictions": predictions, "labels": te_l.tolist(),
           "correct": correct, "total": len(predictions),
           "accuracy": correct / max(1, len(predictions))}
    if with_threshold_tail:
        out["threshold_tail"] = tails
    return out
