"""The two GPU kernels against their XLA forms (interpret mode on the CPU),
the engine routing by platform and shape, and the CPU-side guarantees of
the GPU entry points: optional packages stay optional, ``chip_smoke.py``
refuses to run without a GPU, the compile cache follows
``JAX_COMPILATION_CACHE_DIR``."""

import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grape_vector_db_tpu.ops.int4 import quantize_int4, unpack_int4
from grape_vector_db_tpu.ops.int8 import quantize_int8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _layout(rng, fmt, l=8, c=128, d=64):
    """Random bucketed layout in ``fmt`` with ragged list fills and invalid
    holes: (data, levels [L, C, D] f32, weight plane, fill)."""
    x = rng.standard_normal((l * c, d)).astype(np.float32)
    if fmt == "bf16":
        data = jnp.asarray(x, jnp.bfloat16).reshape(l, c, d)
        lev = np.asarray(data, np.float32)
    elif fmt == "int8":
        codes, _ = quantize_int8(jnp.asarray(x))
        data = codes.reshape(l, c, d)
        lev = np.asarray(data, np.float32)
    else:
        codes, _ = quantize_int4(jnp.asarray(x))
        data = codes.reshape(l, c, d // 2)
        lev = np.asarray(unpack_int4(data), np.float32)
    fill = rng.integers(0, c + 1, l).astype(np.int32)
    fill[0] = c                                   # one full list
    fill[1] = 0                                   # one empty list
    w = rng.uniform(0.5, 1.5, (l, c)).astype(np.float32)
    w[rng.random((l, c)) < 0.2] = 0.0             # deleted cells
    w[np.arange(c)[None, :] >= fill[:, None]] = 0.0
    return data, lev, jnp.asarray(w), jnp.asarray(fill)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_probe_kernel_scores_match_reference(rng, fmt, metric):
    """Per-cell scores: dot(bf16 query, dequantized row) * weight, the
    invalid sentinel on deleted and unfilled cells; float32 sums in another
    order than the reference, hence the tolerance."""
    from grape_vector_db_tpu.ops.distance import prepare_queries
    from grape_vector_db_tpu.ops.ivf_pallas import ivf_probe_scores

    data, lev, w, fill = _layout(rng, fmt)
    b, p = 4, 5
    q = prepare_queries(jnp.asarray(rng.standard_normal((b, 64)),
                                    jnp.float32), metric)
    probe = jnp.asarray(rng.integers(0, 8, (b, p)), jnp.int32)
    got = np.asarray(ivf_probe_scores(q, probe, data, w, fill=fill, fmt=fmt,
                                      interpret=True))
    qb = np.asarray(q.astype(jnp.bfloat16), np.float32)
    pr = np.asarray(probe)
    dots = np.einsum("bd,bpcd->bpc", qb, lev[pr])
    ww = np.asarray(w)[pr]
    ref = np.where(ww == 0.0, -1e9, dots * ww)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_kernel_ivf_topk_matches_xla_probe(rng, fmt, masked):
    """kernel_ivf_topk (interpreted) returns the XLA probe's slots for the
    same layout: same list routing, same selection, filter masks folded
    after the kernel."""
    from grape_vector_db_tpu.index.ivf import _ivf_topk
    from grape_vector_db_tpu.index.ivf_int4 import _ivf_int4_topk
    from grape_vector_db_tpu.index.ivf_int8 import _ivf_int8_topk
    from grape_vector_db_tpu.ops.ivf_pallas import kernel_ivf_topk

    l, c, d, k = 8, 128, 64, 5
    data, lev, w, fill = _layout(rng, fmt, l, c, d)
    cents = rng.standard_normal((l, d)).astype(np.float32)
    cents = jnp.asarray(cents / np.linalg.norm(cents, axis=1, keepdims=True))
    q = jnp.asarray(rng.standard_normal((6, d)), jnp.float32)
    cm = jnp.asarray(rng.random((l, c)) < 0.5) if masked else None
    if fmt == "bf16":
        # the XLA bf16 probe takes norms + validity: with metric="dot" it
        # scores raw dots, which the kernel matches with a 0/1 weight plane
        live = np.asarray(w) > 0
        kv, ks = kernel_ivf_topk(q, cents, data,
                                 jnp.asarray(live, jnp.float32), k=k,
                                 nprobe=3, metric="dot", fmt=fmt, fill=fill,
                                 cell_mask=cm, interpret=True)
        vm = live if cm is None else live & np.asarray(cm)
        xv, xs = _ivf_topk(q, cents, data, jnp.ones((l, c)), jnp.asarray(vm),
                           k=k, nprobe=3, metric="dot")
    else:
        kv, ks = kernel_ivf_topk(q, cents, data, w, k=k, nprobe=3,
                                 metric="dot", fmt=fmt, fill=fill,
                                 cell_mask=cm, interpret=True)
        f = _ivf_int8_topk if fmt == "int8" else _ivf_int4_topk
        xv, xs = f(q, cents, data, w, None, None, cm, k=k, nprobe=3,
                   metric="dot", rescore=0)
    np.testing.assert_array_equal(np.asarray(ks), np.asarray(xs))
    np.testing.assert_allclose(np.asarray(kv), np.asarray(xv), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_segmax_scores_plane_matches_reference(rng, metric):
    """The kernel's strided segment maxima: column j of block blk holds the
    max over rows blk*CB + j + m*SUB, invalid rows excluded."""
    from grape_vector_db_tpu.ops.distance import prepare_queries
    from grape_vector_db_tpu.ops.distance import score_weights
    from grape_vector_db_tpu.ops.segmax_pallas import (CB, SEG, SUB,
                                                       segmax_scores)

    n, d, b = 2 * CB, 64, 5
    vecs = jnp.asarray(rng.standard_normal((n, d)), jnp.bfloat16)
    norms = jnp.linalg.norm(vecs.astype(jnp.float32), axis=1)
    valid = jnp.asarray(rng.random(n) > 0.2)
    q = prepare_queries(jnp.asarray(rng.standard_normal((b, d)),
                                    jnp.float32), metric)
    w = score_weights(norms, valid, metric)
    got = np.asarray(segmax_scores(q, vecs, w, interpret=True))
    qb = np.asarray(q.astype(jnp.bfloat16), np.float32)
    sc = (qb @ np.asarray(vecs, np.float32).T) * np.asarray(w)[None, :]
    sc = np.where(np.asarray(w)[None, :] == 0, -np.inf, sc)
    ref = sc.reshape(b, n // CB, SEG, SUB).max(axis=2).reshape(b, -1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case,expect", [
    (dict(platform="gpu", n=1 << 20, b=128), "segmax_kernel"),
    (dict(platform="gpu", n=1 << 20, b=256), "segmax_kernel"),
    (dict(platform="cpu", n=1 << 20, b=128), "segmax_xla"),
    (dict(platform="gpu", n=1 << 20, b=128, metric="euclidean"),
     "segmax_xla"),
    (dict(platform="gpu", n=1 << 20, b=128, dtype=jnp.float32),
     "segmax_xla"),
    (dict(platform="gpu", n=131_072, b=256), "segmax_kernel"),
    (dict(platform="gpu", n=131_072, b=128), "dense"),
    (dict(platform="gpu", n=65_536, b=8), "dense"),
    (dict(platform="gpu", n=1 << 20, b=256, mode="approx"), "chunked"),
])
def test_exact_engine_routing(case, expect):
    """Which engine scored_topk picks, by platform and shape: the kernel only
    on a GPU, for bf16 rows and angular metrics at >= 262k rows (or 131k
    rows above the 128-query batch)."""
    from grape_vector_db_tpu.ops.distance import exact_engine

    args = dict(d=768, k=10, dtype=jnp.bfloat16, metric="cosine",
                mode="exact")
    args.update(case)
    platform = args.pop("platform")
    got = exact_engine(args["n"], args["d"], args["b"], args["k"],
                       args["dtype"], args["metric"], args["mode"],
                       platform=platform)
    assert got == expect


@pytest.mark.parametrize("platform,metric,expect", [
    ("gpu", "cosine", True), ("gpu", "dot", True),
    ("gpu", "euclidean", False), ("cpu", "cosine", False),
])
def test_ivf_probe_routing(platform, metric, expect):
    """The IVF kinds' _main_topk takes the probe kernel only on a GPU, for
    the angular metrics it scores."""
    from grape_vector_db_tpu.ops.ivf_probe import use_probe_kernel

    assert use_probe_kernel(metric, platform=platform) is expect


def test_cpu_indexes_route_to_xla():
    """On the CPU every index takes the XLA forms: no product path can reach
    a kernel (a GPU-compiled kernel has no CPU lowering)."""
    from grape_vector_db_tpu.index.ivf_int4 import Int4IvfDeviceIndex
    from grape_vector_db_tpu.index.ivf_int8 import Int8IvfDeviceIndex
    from grape_vector_db_tpu.index.ivf import IvfDeviceIndex

    for cls in (IvfDeviceIndex, Int8IvfDeviceIndex, Int4IvfDeviceIndex):
        assert not cls(64, nlist=4, nprobe=2)._use_kernel


_BLOCKED = textwrap.dedent("""
    import sys
    for name in ("msgpack", "zstandard", "xxhash", "grpc", "google.protobuf"):
        sys.modules[name] = None
    import jax
    jax.config.update("jax_platforms", "cpu")
""")


def _run(code: str, cwd=REPO, env_extra=None, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_package_imports_without_optional_packages():
    """``import grape_vector_db_tpu`` needs only JAX, numpy and the standard
    library: msgpack, zstandard, xxhash, grpc and protobuf are blocked."""
    out = _run(_BLOCKED + textwrap.dedent("""
        import grape_vector_db_tpu
        from grape_vector_db_tpu.server import rest
        bad = sorted(m for m in ("msgpack", "zstandard", "xxhash", "grpc")
                     if sys.modules.get(m) is not None)
        print("OK", bad)
    """))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK []" in out.stdout


def test_embedded_data_dir_roundtrip_without_optional_packages(tmp_path):
    """An EmbeddedVectorDB with a data_dir is closed and reopened with the
    optional packages blocked: every acknowledged write reads back."""
    out = _run(_BLOCKED + textwrap.dedent(f"""
        import numpy as np
        from grape_vector_db_tpu import (Document, EmbeddedConfig,
                                         EmbeddedVectorDB, VectorDbConfig)
        def cfg():
            c = EmbeddedConfig(data_dir={str(tmp_path)!r},
                               db=VectorDbConfig(vector_dimension=16))
            c.db.index.initial_capacity = 256
            c.health_check_interval_s = 0
            return c
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((50, 16)).astype(np.float32)
        with EmbeddedVectorDB(cfg()) as db:
            db.upsert([Document(id=f"d{{i}}", content=f"text {{i}}",
                                vector=vecs[i].tolist()) for i in range(50)])
            db.delete(["d7"])
        with EmbeddedVectorDB(cfg()) as db:
            ids = {{f"d{{i}}" for i in range(50)}} - {{"d7"}}
            got = {{i for i in ids if db.get(i) is not None}}
            assert got == ids, sorted(ids - got)
            assert db.get("d7") is None
            v = np.asarray(db.get("d3").vector, np.float32)
            assert np.allclose(v, vecs[3])
        print("OK")
    """))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no ok line on the CPU — in
    the repository and as a lone file without the program."""
    src = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(src, tmp_path / "chip_smoke.py")
        cwd, src = str(tmp_path), str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, src], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(tmp_path, monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set; otherwise the
    fixed .jax_cache/ at the repository root."""
    from grape_vector_db_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("value", [
    {"a": b"\x00\x01", "n": [1, 2.5, None, True, "x"], "nested": {"b": b""}},
    ["ins", [{"id": "d1", "embedding_f32": np.arange(4, dtype="<f4").tobytes(),
              "metadata": {"k": "v"}}]],
    [float("inf"), float("-inf"), 1e-40, "üñí"],
])
def test_codec_roundtrip(value):
    """The stdlib record codec (JSON + raw blobs, zlib for snapshots)
    round-trips bytes, nested containers, non-finite and denormal floats."""
    from grape_vector_db_tpu.storage import codec

    assert codec.unpack(codec.pack(value)) == value
    assert codec.unpack_compressed(codec.pack_compressed(value)) == value


@pytest.mark.gpu
def test_kernels_compile_on_the_gpu(gpu, rng):
    """On a GPU: both kernels compile for the card (no interpret mode) and
    return what their XLA forms return on the same arrays."""
    from grape_vector_db_tpu.ops.distance import (_segmax_exact_topk,
                                                  prepare_queries)
    from grape_vector_db_tpu.ops.ivf_pallas import ivf_probe_scores
    from grape_vector_db_tpu.ops.segmax_pallas import CB, segmax_topk

    n, d = 4 * CB, 128
    vecs = jnp.asarray(rng.standard_normal((n, d)), jnp.bfloat16)
    norms = jnp.linalg.norm(vecs.astype(jnp.float32), axis=1)
    valid = jnp.ones(n, bool)
    q = jnp.asarray(rng.standard_normal((8, d)), jnp.float32)
    kv, ki = segmax_topk(q, vecs, norms, valid, k=10, metric="cosine")
    xv, xi = _segmax_exact_topk(prepare_queries(q, "cosine"), vecs, norms,
                                valid, 10, "cosine", n)
    np.testing.assert_array_equal(np.asarray(ki), np.asarray(xi))
    np.testing.assert_allclose(np.asarray(kv), np.asarray(xv), atol=1e-4)
    data, lev, w, fill = _layout(rng, "int8")
    probe = jnp.asarray(rng.integers(0, 8, (4, 3)), jnp.int32)
    qp = prepare_queries(q[:4, :64], "cosine")
    got = np.asarray(ivf_probe_scores(qp, probe, data, w, fill=fill,
                                      fmt="int8"))
    qb = np.asarray(qp.astype(jnp.bfloat16), np.float32)
    ref = np.einsum("bd,bpcd->bpc", qb, lev[np.asarray(probe)])
    ww = np.asarray(w)[np.asarray(probe)]
    np.testing.assert_allclose(got, np.where(ww == 0, -1e9, ref * ww),
                               rtol=1e-5, atol=1e-4)
