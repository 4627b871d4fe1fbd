"""Every example must run under the CPU platform (examples are the
documented user surface — they run in CI, not just in the README)."""

import importlib.util
import os
import sys

import pytest

EXAMPLES = [
    "embedded_mode_simple",
    "embedded_mode_complete",
    "single_node_simple",
    "single_node_server",
    "cluster_3node_simple",
    "cluster_3node_complete",
    "builtin_load_balancing_demo",
    "advanced_storage_demo",
    "advanced_filtering_demo",
    "binary_quantization_demo",
    "int8_ivf_demo",
    "openai_compatible",
    "runtime_scaling_demo",
    "sharded_mesh_demo",
    "capacity_tier_demo",
]

EX_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "examples")


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"gvdb_example_{name}", os.path.join(EX_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # examples that write relative dirs stay in tmp
    mod = load(name)
    import inspect

    kwargs = {}
    params = inspect.signature(mod.main).parameters
    if "data_dir" in params:
        kwargs["data_dir"] = str(tmp_path / "data")
    mod.main(**kwargs)
