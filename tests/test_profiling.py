"""The trace reduction (utils/profiling.py) on a trace recorded here."""

import jax
import jax.numpy as jnp

from torus_fhe_tpu.utils import profiling


def test_busy_is_union_of_intervals():
    assert profiling._busy_ns([]) == 0
    assert profiling._busy_ns([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25


def test_summarize_recorded_trace(tmp_path):
    x = jnp.ones((128, 128))
    f = jax.jit(lambda x: (x @ x).sum())
    f(x).block_until_ready()
    with profiling.device_trace(str(tmp_path)):
        f(x).block_until_ready()
    summary = profiling.summarize_trace(str(tmp_path))
    assert summary["total_device_us"] > 0
    assert 0.0 <= summary["idle_share"] <= 1.0
    assert "GEMM" in summary["by_category"]
    assert profiling.trace_lanes(str(tmp_path))
    assert "idle share" in profiling.format_summary(summary)
