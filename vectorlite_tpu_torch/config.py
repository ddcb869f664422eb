"""Runtime configuration profiles and the device they serve on.

The reference selects HNSW graph degree and dtype behavior at **compile
time** via Cargo features (reference: Cargo.toml:15-22,
src/index/hnsw.rs:95-109). Here profiles are runtime parameters:

==================  ====  ====  ==========================================
profile              M     M0   flat device dtype
==================  ====  ====  ==========================================
default (fast)       16    32   auto (f32; bf16 / int8 + exact rescore at scale)
memory-optimized      8    16   bfloat16
high-accuracy        32    64   float32
quantized            16    32   int8 (+ exact rescore)
pq                   16    32   pq: 4-bit codes, ADC selection (K5) + exact rescore
==================  ====  ====  ==========================================

Select via ``VectorLiteConfig.profile("memory-optimized")`` or the
``VECTORLITE_PROFILE`` environment variable.

The device is explicit: ``None`` means the CUDA card, and a machine
without one raises instead of quietly serving from the CPU. Tests pass
``device="cpu"``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

_PROFILES = {
    "default": dict(hnsw_m=16, hnsw_m0=32, device_dtype="auto"),
    "fast": dict(hnsw_m=16, hnsw_m0=32, device_dtype="auto"),
    "memory-optimized": dict(hnsw_m=8, hnsw_m0=16, device_dtype=torch.bfloat16),
    "high-accuracy": dict(hnsw_m=32, hnsw_m0=64, device_dtype=torch.float32),
    # int8 corpus on the flat index (exact host re-score of the k
    # winners); 4x less device memory than f32
    "quantized": dict(hnsw_m=16, hnsw_m0=32, device_dtype="int8"),
    # product-quantized flat corpus: 4-bit codes + codebooks on the device
    # (96 bytes a row at 384-d), ADC selection, exact host re-score
    "pq": dict(hnsw_m=16, hnsw_m0=32, device_dtype="pq"),
}


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain-torch paths on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


@dataclass
class VectorLiteConfig:
    hnsw_m: int = 16
    hnsw_m0: int = 32
    hnsw_ef_construction: int = 100
    hnsw_ef_search: int = 128
    device_dtype: object = "auto"
    profile_name: str = "default"
    #: Multi-device serving: number of devices to shard collections over
    #: (``VECTORLITE_MESH``; 0/1 = one device; dist/sharding.py)
    mesh_devices: int = 0
    #: torch device for the index tensors; None = the CUDA card
    device: Optional[object] = None

    @classmethod
    def profile(cls, name: str, **overrides) -> "VectorLiteConfig":
        params = _PROFILES.get(name)
        if params is None:
            raise ValueError(
                f"Unknown profile '{name}'. "
                f"Available: {sorted(_PROFILES)}"
            )
        return cls(profile_name=name, **{**params, **overrides})

    @classmethod
    def from_env(cls, **overrides) -> "VectorLiteConfig":
        name = os.environ.get("VECTORLITE_PROFILE", "default")
        cfg = cls.profile(name, **overrides)
        ef_c = os.environ.get("VECTORLITE_EF_CONSTRUCTION")
        ef_s = os.environ.get("VECTORLITE_EF_SEARCH")
        if ef_c:
            cfg.hnsw_ef_construction = int(ef_c)
        if ef_s:
            cfg.hnsw_ef_search = int(ef_s)
        mesh = os.environ.get("VECTORLITE_MESH")
        if mesh:
            cfg.mesh_devices = int(mesh)
        return cfg
