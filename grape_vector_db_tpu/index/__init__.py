"""Index layer — device-resident ANN/exact indexes.

Replaces the reference's index layer (src/index.rs, src/quantization.rs):
- FlatDeviceIndex: exact chunked-matmul scan (replaces full-scan cosine and is
  the recall=1.0 baseline the reference never had at speed).
- BinaryDeviceIndex: packed-bit Hamming pre-scan + exact rescore
  (quantization.rs multi_stage_search, but batched on the device).
- IvfDeviceIndex: k-means partitioned scan (the reference's FaissVectorIndex
  trains k-means but then linear-scans anyway, index.rs:620-640 — ours actually
  prunes).
- Int8DeviceIndex: int8 pre-scan at half the bytes + exact bf16 rescore
  (no reference analog — exists because device memory bandwidth rewards it).
- Int8IvfDeviceIndex (index/ivf_int8.py): IVF partitioning over int8-resident
  lists — the probe at half the bytes/list and/or ~2x rows/device in the
  int8-only capacity configuration.
"""

from grape_vector_db_tpu.index.base import VectorIndex, IndexStats
from grape_vector_db_tpu.index.flat import FlatDeviceIndex
from grape_vector_db_tpu.index.binary import BinaryDeviceIndex
from grape_vector_db_tpu.index.int8 import Int8DeviceIndex

__all__ = ["VectorIndex", "IndexStats", "FlatDeviceIndex", "BinaryDeviceIndex",
           "Int8DeviceIndex"]
