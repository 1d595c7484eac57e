"""Device meshes and sharded gate execution.

Replacement for the reference's parallel runtimes (SURVEY.md §2c):
OpenMP `parallel for` over parties / gate batches (src/
threshold_decryption_functions.cpp:407, src/KNN_medical_data.cpp:681) and the
Julia Distributed.jl fan-out (3-gen-mk-tfhe/VolumeMatching.jl:1-81). Instead of
threads and RPC, one `jax.sharding.Mesh` spans the chips:

  * axis "batch"  — data parallelism over independent ciphertexts/gates. The
    bootstrapping key and keyswitch table are replicated; each chip blind-
    rotates its shard of the gate batch. This is the throughput axis
    (BASELINE: bootsAND gates/s).
  * axis "party"  — the multikey / threshold party dimension. Per-party
    partial decryptions and per-party keyswitch contributions reduce with
    `psum` over this axis (the reference's `reduce(+, ...)` at
    mk_internals.jl:90,724,742 and the omp-critical accumulation at
    threshold_decryption_functions.cpp:423-431).

Multi-host: the same mesh built from `jax.devices()` after
`jax.distributed.initialize()` spans every host; nothing below changes.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"
PARTY_AXIS = "party"


def make_mesh(n_batch: int | None = None, n_party: int = 1,
              devices: Sequence[jax.Device] | None = None) -> Mesh:
    """Build a (batch, party) mesh over the available devices.

    With ``n_batch=None`` all remaining devices go to the batch axis. The
    cards of a host reach each other all to all (NVLink), so the layout is a
    plain reshape of the device list.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_batch is None:
        n_batch = len(devices) // n_party
    use = np.asarray(devices[: n_batch * n_party]).reshape(n_batch, n_party)
    return Mesh(use, (BATCH_AXIS, PARTY_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (B, ...) ciphertext arrays: batch axis split over chips."""
    return NamedSharding(mesh, P(BATCH_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Sharding for keys (BK/KSK): replicated on every chip."""
    return NamedSharding(mesh, P())


def shard_lwe_batch(sample, mesh: Mesh):
    """Place a batched LweSample so its leading axis is split over `batch`."""
    from ..lwe import LweSample

    sh = batch_sharding(mesh)
    return LweSample(jax.device_put(sample.a, sh), jax.device_put(sample.b, sh))


def replicate_cloud_key(ck, mesh: Mesh):
    """Replicate a CloudKey pytree onto every device of the mesh."""
    rep = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, rep), ck)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Multi-host bring-up (the Distributed.jl `addprocs` analog,
    3-gen-mk-tfhe/VolumeMatching.jl:1-8): call once per host before building
    meshes; afterwards ``jax.devices()`` spans every host and `make_mesh`
    needs no changes.

    Arguments default to the standard JAX env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); on a
    single process (no env, no args) this is a no-op returning False so
    single-host flows never pay coordination setup.
    """
    import os

    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else \
        int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    if addr is None and nproc in (0, 1):
        return False
    if process_id is None:
        env_pid = os.environ.get("JAX_PROCESS_ID")
        # leave None when unset: jax.distributed.initialize auto-detects where
        # the launcher provides it, and raises a clear error otherwise —
        # defaulting to 0 here would make every host claim process 0 and hang.
        process_id = int(env_pid) if env_pid is not None else None
    jax.distributed.initialize(
        coordinator_address=addr, num_processes=nproc or None,
        process_id=process_id)
    return True
