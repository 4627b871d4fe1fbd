"""Int8-resident IVF demo — the bandwidth + capacity engine.

No reference analog (the reference's IVF trained k-means but linear-scanned,
index.rs:620-640; its quantization stops at 1-bit binary). This engine exists
because device memory bandwidth rewards it: the probe reads each probed list
in place, and int8 codes halve the bytes per list (and double the rows a
device holds in the codes-only config).

This demo runs the same flows at toy scale on whatever backend is available
(the CPU uses the XLA probe; a GPU the probe kernel).
"""

import time

import numpy as np

from grape_vector_db_tpu.index.ivf_int8 import Int8IvfDeviceIndex
from grape_vector_db_tpu.index import FlatDeviceIndex


def main() -> None:
    n, d, q, k = 20_000, 128, 64, 10
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 64, n)]
            + 0.2 * rng.standard_normal((n, d))).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    queries = (vecs[rng.integers(0, n, q)]
               + 0.05 * rng.standard_normal((q, d)).astype(np.float32))

    flat = FlatDeviceIndex(d, storage_dtype="float32", initial_capacity=32768)
    flat.add_batch(ids, vecs)
    oracle = flat.search_batch(queries, k)

    def recall(hits):
        return np.mean([
            len({h[0] for h in g} & {h[0] for h in w}) / k
            for g, w in zip(hits, oracle)
        ])

    # Bandwidth config: int8 probe + exact bf16 rescore (default)
    bw = Int8IvfDeviceIndex(d, nlist=64, nprobe=8, rescore=64,
                            initial_capacity=32768)
    bw.add_batch(ids, vecs)
    bw.search_batch(queries[:8], k)  # warm the jit
    t0 = time.perf_counter()
    hits = bw.search_batch(queries, k)
    dt = time.perf_counter() - t0
    st = bw.get_stats()
    print(f"bandwidth config : recall@{k} {recall(hits):.3f}  "
          f"{q / dt:,.0f} q/s  {st.memory_usage_mb:.1f} MB")

    # Capacity config: int8-only (~2x rows per chip), no bf16 plane
    cap = Int8IvfDeviceIndex(d, nlist=64, nprobe=8, keep_bf16=False,
                             initial_capacity=32768)
    cap.add_batch(ids, vecs)
    cap.search_batch(queries[:8], k)
    t0 = time.perf_counter()
    hits = cap.search_batch(queries, k)
    dt = time.perf_counter() - t0
    st = cap.get_stats()
    print(f"capacity config  : recall@{k} {recall(hits):.3f}  "
          f"{q / dt:,.0f} q/s  {st.memory_usage_mb:.1f} MB  "
          f"(no bf16 plane; get_vector dequantizes)")

    # reconstruction fidelity in the capacity config
    got = cap.get_vector("v7")
    cos = float(got @ vecs[7]
                / (np.linalg.norm(got) * np.linalg.norm(vecs[7])))
    print(f"int8 reconstruction cosine vs original: {cos:.5f}")

    # filtered search stays on the fast probe (mask folds post-kernel)
    allowed = {f"v{i}" for i in range(0, n, 100)}
    fhits = bw.search_batch(queries[:4], 5, mask=bw.compile_mask(allowed))
    assert all({h[0] for h in row} <= allowed for row in fhits)
    print(f"filtered search over {len(allowed)} allowed ids: OK")


if __name__ == "__main__":
    main()
