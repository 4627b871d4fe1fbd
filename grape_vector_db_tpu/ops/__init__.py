"""Device-side compute kernels (JAX/XLA + Pallas).

This package replaces the reference's per-point CPU hot loops
(index.rs HNSW walk, quantization.rs Hamming scan, sparse.rs BM25 accumulation)
with batched kernels over device-resident arrays.
"""

from grape_vector_db_tpu.ops.distance import (
    l2_normalize,
    prepare_queries,
    scored_topk,
    score_block,
)
from grape_vector_db_tpu.ops.topk import merge_topk, take_topk
from grape_vector_db_tpu.ops.hamming import (
    asym_topk,
    pack_bits,
    hamming_scores,
    hamming_topk,
    words_per_vector,
)
from grape_vector_db_tpu.ops.kmeans import assign_clusters, kmeans
from grape_vector_db_tpu.ops.graph import beam_search, build_knn_graph
from grape_vector_db_tpu.ops.pq import adc_topk, encode_pq, train_pq

__all__ = [
    "l2_normalize",
    "prepare_queries",
    "scored_topk",
    "score_block",
    "merge_topk",
    "take_topk",
    "asym_topk",
    "pack_bits",
    "hamming_scores",
    "hamming_topk",
    "words_per_vector",
    "kmeans",
    "assign_clusters",
    "build_knn_graph",
    "beam_search",
    "train_pq",
    "encode_pq",
    "adc_topk",
]
