"""Published device peaks for the roofline tools, keyed by JAX's
``device_kind``. A device that is not listed is an error, never a default:
add it with its source.

H100 SXM5 80 GB: 3.35 TB/s of HBM3 (NVIDIA H100 Tensor Core GPU data
sheet; JAX reports it as "NVIDIA H100 80GB HBM3"). The rate assumes the
card's full 700 W power limit; read ``nvidia-smi --query-gpu=power.limit``
beside any share quoted against it.
"""

HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def hbm_peak_gbps(device_kind: str) -> float:
    if device_kind not in HBM_PEAK_GBPS:
        raise KeyError(
            f"no published HBM peak for device_kind {device_kind!r}; add it "
            "to tools/peaks.py with its source"
        )
    return HBM_PEAK_GBPS[device_kind]
