"""Test harness: force an 8-device virtual CPU mesh before JAX initializes.

This is the in-process fake-mesh layer called for by SURVEY.md §4.3 — multi-chip
sharding tests run on host CPU devices, so the whole distributed suite runs in
one process with no accelerator attached.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

# The jaxtyping pytest plugin imports jax before this conftest runs, so the env
# var above can be read too late — force the platform through the live config
# as well (backends initialize lazily, so this still lands in time).
import jax

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", "tests must run on the virtual CPU mesh"
assert jax.device_count() == 8, "expected 8 virtual CPU devices"

# Persistent compilation cache: the suite compiles many shard_map programs
# (every ClusterNode serves a mesh-sharded index now); caching them across
# runs roughly halves repeat-suite wall clock. JAX_COMPILATION_CACHE_DIR
# wins when set; otherwise the repository's fixed .jax_cache/.
from grape_vector_db_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import functools

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on a GPU (card-only tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX runs on "
                    f"{jax.default_backend()}")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Run the GPU kernels through the Pallas interpreter for this test.

    Product code never passes ``interpret=True``: it compiles the kernels on
    a GPU and takes the XLA forms elsewhere. A test that wants the index
    plumbing around a kernel (weight planes, fills, masks, shard_map) sets
    the index's ``_use_kernel`` and asks for this fixture, which rebinds the
    kernel entry points to their interpret-mode calls."""
    from grape_vector_db_tpu.ops import ivf_pallas, segmax_pallas

    def interpreted(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            kwargs["interpret"] = True
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(ivf_pallas, "ivf_probe_scores",
                        interpreted(ivf_pallas.ivf_probe_scores))
    monkeypatch.setattr(segmax_pallas, "segmax_scores",
                        interpreted(segmax_pallas.segmax_scores))
