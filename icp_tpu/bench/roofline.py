"""Published device peaks, keyed by the ``device_kind`` JAX reports.

A roofline share is the least time the device could take for an op — the
larger of its operations over the peak rate and its bytes over the peak
bandwidth — divided by the measured time.  This module keeps the peaks;
the per-layer operation and byte counts derived from shapes belong to the
benchmark and are not derived yet, so the harness reports the share as
"not measured".

Source: NVIDIA's H100 data sheet (SXM part, dense rates without sparsity),
which assumes the full 700 W power limit.  A card set below that limit
cannot hold its top clock under load, so every share is reported with the
card's power limit beside it.

A device that is not in the table is an error, not a default.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    fp32_flops: float  # FP32 outside the tensor cores, FLOP/s
    tf32_flops: float  # tensor cores, TF32
    bf16_flops: float  # tensor cores, bf16 (f32 accumulate)
    hbm_bytes_per_s: float
    hbm_bytes: float
    power_limit_w: float  # the limit the published rates assume


_H100_SXM = DeviceSpec(
    name="NVIDIA H100 SXM",
    fp32_flops=67e12,
    tf32_flops=495e12,
    bf16_flops=989e12,
    hbm_bytes_per_s=3.35e12,
    hbm_bytes=80e9,
    power_limit_w=700.0,
)

# jax.devices()[0].device_kind -> spec
_SPECS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def device_spec(device_kind: str) -> DeviceSpec:
    """Peaks for ``device_kind``; raises ``KeyError`` for an unknown device."""
    try:
        return _SPECS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add its "
            f"data-sheet row to icp_tpu/bench/roofline.py"
        ) from None
