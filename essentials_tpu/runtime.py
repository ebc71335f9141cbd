"""Device runtime introspection.

Capability parity with the reference's L0 "gcuda" layer
(/root/reference/include/gunrock/cuda/): context (context.hxx:54-206) and
the device_properties.hxx constexpr tables. XLA owns kernel launches, so
this layer reduces to device discovery, the peak rates a roofline share
divides by, and profiler hooks.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax

from essentials_tpu.errors import EssentialsError


@dataclass(frozen=True)
class DeviceProperties:
    kind: str                  # jax device_kind
    platform: str              # jax platform ("gpu", "cpu")
    mem_gib: float | None      # device memory
    hbm_gbps: float | None     # peak memory bandwidth (roofline denominator)
    l2_mib: float | None       # last-level cache
    sm_count: int | None       # streaming multiprocessors
    bf16_tflops: float | None  # dense bf16 tensor-core peak


# Peaks keyed by exact jax ``device_kind``. Source: NVIDIA H100 data sheet
# (SXM part; dense rates without sparsity) and the Hopper architecture
# white paper. The CPU row has no peak, so no roofline share is reported.
_DEVICE_TABLE = {
    "NVIDIA H100 80GB HBM3": dict(platform="gpu", mem_gib=80.0,
                                  hbm_gbps=3350.0, l2_mib=50.0,
                                  sm_count=132, bf16_tflops=989.0),
    "cpu": dict(platform="cpu", mem_gib=None, hbm_gbps=None, l2_mib=None,
                sm_count=None, bf16_tflops=None),
}


def device_properties(device=None) -> DeviceProperties:
    """Properties of a device (default: first). Reference parity:
    gcuda device_properties + standard_context_t::props. A device kind
    missing from the table is an error, not a default."""
    device = device or jax.devices()[0]
    kind = str(device.device_kind)
    row = _DEVICE_TABLE.get(kind)
    if row is None:
        raise EssentialsError(
            f"no peak table entry for device kind {kind!r} "
            f"(platform {device.platform}); add it to runtime._DEVICE_TABLE")
    return DeviceProperties(kind=kind, **row)


def num_devices() -> int:
    return jax.device_count()


def backend() -> str:
    return jax.default_backend()


# --- profiling (reference parity: NVBench/CUPTI counters + timer --------
# benchmarks/sssp_bench.cu:60-66; here: the XLA profiler produces per-op
# device traces viewable in TensorBoard/XProf/Perfetto).

def start_trace(log_dir: str) -> None:
    jax.profiler.start_trace(log_dir)


def stop_trace() -> None:
    jax.profiler.stop_trace()


class trace:
    """Context manager: ``with runtime.trace("/tmp/trace"): run()``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def __enter__(self):
        start_trace(self.log_dir)
        return self

    def __exit__(self, *exc):
        stop_trace()
        return False
