"""Key and ciphertext serialization (the cloud/client split).

Replacement for the reference's tfhe_io file round-trips
(`export_tfheGateBootstrappingSecretKeySet_toFile` in src/KeyGen.cpp:41-51,
per-bit ciphertext arrays in src/bootstrap_modules.cpp:99-103, Shamir shards
in src/KeySplit.cpp:120-150). Every stage of a pipeline can round-trip through
files: keygen on one host, evaluation on another, decryption on a third — the
reference's `test/` directory workflow (SURVEY.md §5 checkpoint/resume).

Format: numpy .npz with a `__schema__` tag, a params-registry tag (parameter
sets are static code-side dataclasses, stored by name + field values), and the
pytree arrays.
"""

from __future__ import annotations

import dataclasses
import io
import json

import jax
import numpy as np

_SCHEMA = "torus_fhe_tpu.v1"


def _params_to_json(params) -> str:
    d = {"__class__": type(params).__name__}
    d.update(dataclasses.asdict(params))
    return json.dumps(d)


def _params_from_json(s: str):
    from ..core import params as P

    d = json.loads(s)
    cls = getattr(P, d.pop("__class__"))
    return cls(**d)


def _flatten(tree):
    leaves, treedef = jax.tree.flatten(tree)
    return leaves, treedef


def save(path: str, kind: str, tree, params=None) -> None:
    """Serialize a pytree of arrays (key, ciphertext batch, share set...)."""
    leaves, treedef = _flatten(tree)
    payload = {f"leaf_{i}": np.asarray(jax.device_get(l)) for i, l in enumerate(leaves)}
    meta = {"schema": _SCHEMA, "kind": kind, "n_leaves": len(leaves)}
    if params is not None:
        meta["params"] = _params_to_json(params)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **payload)


def load(path: str):
    """Returns (kind, leaves, params_or_None); rebuild with the matching
    `load_*` helper or jax.tree.unflatten."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        assert meta["schema"] == _SCHEMA, meta
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
        params = _params_from_json(meta["params"]) if "params" in meta else None
    return meta["kind"], leaves, params


def save_named(path: str, kind: str, mapping: dict, params=None,
               extra_meta: dict | None = None) -> None:
    """Serialize a flat {name: array} mapping (None values skipped), with
    optional JSON-able ``extra_meta``. Robust to optional fields, unlike the
    positional `save` layout."""
    payload = {}
    names = []
    for name, v in mapping.items():
        if v is None:
            continue
        payload[f"k_{name}"] = np.asarray(jax.device_get(v))
        names.append(name)
    meta = {"schema": _SCHEMA, "kind": kind, "names": names}
    if params is not None:
        meta["params"] = _params_to_json(params)
    if extra_meta:
        meta["extra"] = extra_meta
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **payload)


def load_named(path: str):
    """Returns (kind, {name: np.ndarray}, params_or_None, extra_meta)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        assert meta["schema"] == _SCHEMA, meta
        if "names" not in meta:
            raise ValueError(f"{path} is a positional-format file, not named")
        arrs = {name: z[f"k_{name}"] for name in meta["names"]}
        params = _params_from_json(meta["params"]) if "params" in meta else None
    return meta["kind"], arrs, params, meta.get("extra", {})


def save_secret_key(path: str, sk) -> None:
    save(path, "secret_key", sk.key, params=sk.params)


def load_secret_key(path: str):
    from ..boot.api import SecretKey
    from ..lwe import LweKey

    kind, leaves, params = load(path)
    assert kind == "secret_key", kind
    return SecretKey(params, LweKey(jax.numpy.asarray(leaves[0])))


def save_cloud_key(path: str, ck) -> None:
    """Store the *compact* cloud key: keyswitch table + raw TGSW samples
    (~20 MB at the 128-bit set). Either product form — conv kernels or the
    F-block layout — is rebuilt from the samples on load, so a saved
    key drives the fast path after a round-trip (the reference's tfhe_io
    role, src/KeyGen.cpp:41-51). Records which forms were materialised at
    save time as the default rebuild set."""
    bk = ck.bootstrap_key
    forms = [f for f, v in (("conv", bk.kernels), ("fblock", bk.fb))
             if v is not None]
    mapping = {"ks": ck.keyswitch_key.mat,
               "ks_meta": np.array([ck.keyswitch_key.n_in,
                                    ck.keyswitch_key.n_out])}
    if bk.samples is not None:
        mapping["samples"] = bk.samples
    else:  # legacy keys built before the samples form existed
        assert bk.kernels is not None, \
            "cloud key has neither samples nor conv kernels"
        mapping["bk"] = bk.kernels
        forms = ["conv"]
    save_named(path, "cloud_key", mapping, params=ck.params,
               extra_meta={"forms": forms})


def load_cloud_key(path: str, forms=None, fblock_device=None):
    """Load a cloud key, rebuilding the requested product form(s) from the
    compact samples (default: the forms that were materialised at save).
    ``fblock_device``: where to expand the F-block form (the expanded key is
    ~3.3 GB — build it where it will be used)."""
    import jax.numpy as jnp

    from ..boot.api import CloudKey
    from ..boot.bootstrap import BootstrapKey, rebuild_bk_forms
    from ..boot.keyswitch import KeyswitchKey

    try:
        kind, arrs, params, extra = load_named(path)
    except ValueError:
        # legacy positional layout (pre-named format): dict leaves flatten in
        # sorted key order -> ("bk", "ks", "ks_meta")
        kind, leaves, params = load(path)
        arrs = dict(zip(("bk", "ks", "ks_meta"), leaves))
        extra = {}
    assert kind == "cloud_key", kind
    ksk = KeyswitchKey(jnp.asarray(arrs["ks"]), int(arrs["ks_meta"][0]),
                       int(arrs["ks_meta"][1]))
    if "samples" in arrs:
        forms = tuple(forms if forms is not None
                      else extra.get("forms") or ("conv",))
        bk = rebuild_bk_forms(arrs["samples"], params, forms=forms,
                              fblock_device=fblock_device)
    else:
        bk = BootstrapKey(jnp.asarray(arrs["bk"]))
    return CloudKey(params, bk, ksk)


def save_lwe(path: str, sample, params=None) -> None:
    save(path, "lwe", {"a": sample.a, "b": sample.b}, params=params)


def load_lwe(path: str):
    import jax.numpy as jnp

    from ..lwe import LweSample

    kind, leaves, _ = load(path)
    assert kind == "lwe", kind
    return LweSample(jnp.asarray(leaves[0]), jnp.asarray(leaves[1]))


def save_mk_cloud_key(path: str, ck) -> None:
    """3gen MK cloud key. Prefers the compact raw samples (rebuilds any
    product form on load); falls back to the conv kernels for keys generated
    without keep_samples."""
    mapping = {"ks": ck.ks_mat}
    forms = [f for f, v in (("conv", ck.bk_kernels), ("fblock", ck.bk_fb),
                            ("fbstream", ck.bk_fb_sel))
             if v is not None]
    if ck.bk_samples is not None:
        mapping["samples"] = ck.bk_samples
    else:
        assert ck.bk_kernels is not None
        mapping["bk"] = ck.bk_kernels
        forms = ["conv"]
    save_named(path, "mk_cloud_key", mapping, params=ck.params,
               extra_meta={"parties": ck.parties, "forms": forms})


def load_mk_cloud_key(path: str, forms=None, fblock_device=None):
    import jax.numpy as jnp

    from ..mk.keys3gen import MKCloudKey, hi_round_samples, mk_fb_geometry
    from ..ops import fblock, poly

    try:
        kind, arrs, params, extra = load_named(path)
        parties = int(extra["parties"])
    except ValueError:
        # legacy positional layout: sorted keys -> ("bk", "ks", "parties")
        kind, leaves, params = load(path)
        arrs = dict(zip(("bk", "ks"), leaves[:2]))
        parties = int(np.asarray(leaves[2]).reshape(-1)[0])
        extra = {}
    assert kind == "mk_cloud_key", kind
    ks = jnp.asarray(arrs["ks"])
    if "samples" not in arrs:
        return MKCloudKey(jnp.asarray(arrs["bk"]), ks, parties, params)
    samples = arrs["samples"]  # (P*n, l, 2, 2, N) host
    forms = tuple(forms if forms is not None
                  else extra.get("forms") or ("conv",))
    kernels = fb = fb_sel = None
    if "conv" in forms:
        kern = samples.reshape(samples.shape[0], samples.shape[1] * 2, 2,
                               samples.shape[-1])
        kernels = jnp.asarray(poly.pack_kernels_host(kern, params.rlwe_bits))
    if "fblock" in forms or "fbstream" in forms:
        from ..mk.keys3gen import mk_fb64_geometry, mk_fb_supported

        ctx = jax.default_device(fblock_device) if fblock_device is not None \
            else _nullctx()
        with ctx:
            if "fblock" in forms:
                fb = fblock.build_fblocks(hi_round_samples(samples),
                                          mk_fb_geometry(params, parties))
            if "fbstream" in forms:
                if mk_fb_supported(params):
                    fb_sel = jnp.asarray(fblock.build_sel(
                        hi_round_samples(samples),
                        mk_fb_geometry(params, parties)))
                else:  # wide-digit sets: exact 64-bit lines
                    fb_sel = jnp.asarray(fblock.build_sel(
                        samples, mk_fb64_geometry(params, parties)))
    return MKCloudKey(kernels, ks, parties, params, fb, jnp.asarray(samples),
                      fb_sel)


class _nullctx:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


_CCS_FIELDS = ("d_kern", "f0_kern", "f1_kern", "pk_kern", "sk_kern",
               "ks_mats", "d_sel", "f0_sel", "f1_sel", "pk_fb", "sk_fb")
_KMS_FIELDS = ("gsw_kern", "d_kern", "f0_kern", "f1_kern", "pk_kern",
               "sk_kern", "ks_mats", "gsw_sel")


def save_ccs_cloud_key(path: str, ck) -> None:
    """CCS cloud key round-trip (the reference's MKCloudKey file role,
    mk_api.jl:440-459)."""
    save_named(path, "ccs_cloud_key",
               {f: getattr(ck, f) for f in _CCS_FIELDS}, params=ck.params,
               extra_meta={"parties": ck.parties})


def load_ccs_cloud_key(path: str):
    import jax.numpy as jnp

    from ..mk.ccs import CCSCloudKey

    kind, arrs, params, extra = load_named(path)
    assert kind == "ccs_cloud_key", kind
    vals = {f: (jnp.asarray(arrs[f]) if f in arrs else None)
            for f in _CCS_FIELDS}
    return CCSCloudKey(parties=int(extra["parties"]), params=params, **vals)


def save_kms_cloud_key(path: str, ck) -> None:
    """KMS cloud key round-trip (MKCloudKey_new, mk_api.jl:436-456)."""
    save_named(path, "kms_cloud_key",
               {f: getattr(ck, f) for f in _KMS_FIELDS}, params=ck.params,
               extra_meta={"parties": ck.parties})


def load_kms_cloud_key(path: str):
    import jax.numpy as jnp

    from ..mk.kms import KMSCloudKey

    kind, arrs, params, extra = load_named(path)
    assert kind == "kms_cloud_key", kind
    vals = {f: (jnp.asarray(arrs[f]) if f in arrs else None)
            for f in _KMS_FIELDS}
    return KMSCloudKey(parties=int(extra["parties"]), params=params, **vals)


def save_share_set(path: str, repo) -> None:
    keys = sorted(repo.shares)
    save(path, "share_set",
         {"tp": np.array([repo.t, repo.p]),
          "index": np.array(keys, np.int64),
          "shares": np.stack([repo.shares[k] for k in keys])})


def load_share_set(path: str):
    from ..threshold.shares import ShareSet

    kind, leaves, _ = load(path)
    assert kind == "share_set", kind
    index, shares, tp = leaves  # dict leaves flatten in sorted key order
    repo = ShareSet(int(tp[0]), int(tp[1]))
    for (party, gid), s in zip(index.tolist(), shares):
        repo.shares[(int(party), int(gid))] = s
    return repo
