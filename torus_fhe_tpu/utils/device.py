"""Device placement and compile-cache helpers.

Key generation is a one-time host-friendly job (SURVEY.md §7): its many small
sampling/packing ops would each pay a kernel launch on the accelerator, so
keygen runs on the local CPU backend and ships the finished key material to
the accelerator in one transfer — as the reference does all keygen CPU-side
before exporting key files (src/KeyGen.cpp:31-57).
"""

from __future__ import annotations

import contextlib
import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def configure_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself). Otherwise the cache lives at the fixed path ``<repo>/.cache/jax``:
    the path is part of the cache key, so a moving directory never hits.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(REPO_ROOT, ".cache", "jax")
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def cpu_device():
    return jax.devices("cpu")[0]


@contextlib.contextmanager
def on_host():
    """Run enclosed jax ops on the CPU backend (keygen, packing)."""
    with jax.default_device(cpu_device()):
        yield


def to_device(tree, device=None):
    """Move every array leaf of a pytree to ``device`` (default: the default
    accelerator) in one batched transfer."""
    if device is None:
        device = jax.devices()[0]
    return jax.tree.map(
        lambda x: jax.device_put(x, device) if hasattr(x, "dtype") else x, tree)
