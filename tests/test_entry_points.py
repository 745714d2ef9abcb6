"""Entry-point plumbing: the one compile-cache helper, and the main-path
modules importing where pandas is not installed."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

from letf_tpu.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_env_var_is_left_to_jax(monkeypatch, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_default_is_fixed_dir_in_checkout(monkeypatch,
                                                restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.enable_compile_cache()
    assert d == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == d
    # Same path on every call (no pid, time or temp name in it).
    assert compile_cache.enable_compile_cache() == d
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_cache_helper_sets_nothing_else(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    before = dict(jax.config.values)
    compile_cache.enable_compile_cache()
    after = dict(jax.config.values)
    changed = {k for k in after if after[k] != before.get(k)}
    assert changed == {"jax_compilation_cache_dir"}


def test_no_other_code_sets_the_cache():
    """The helper is the only place in the program that places the
    compile cache."""
    hits = []
    files = [*ROOT.glob("*.py"), *(ROOT / "letf_tpu").rglob("*.py"),
             *(ROOT / "tests").rglob("*.py")]
    for p in files:
        if p.name == "test_entry_points.py":
            continue
        text = p.read_text()
        if ('update("jax_compilation_cache_dir"' in text
                or '"jax_persistent_cache' in text):
            hits.append(p.relative_to(ROOT).as_posix())
    assert hits == ["letf_tpu/utils/compile_cache.py"]


_BLOCK_PANDAS = """
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "pandas" or name.startswith("pandas."):
            raise ImportError("pandas is not installed here")
sys.meta_path.insert(0, Block())
importlib.import_module(sys.argv[1])
assert "pandas" not in sys.modules
print("imported", sys.argv[1])
"""


@pytest.mark.parametrize("module", [
    "letf_tpu.parallel.mc_runner", "letf_tpu.reporting",
    "letf_tpu.tax.device_bridge", "letf_tpu.ops.path_batched",
    "chip_smoke"])
def test_main_path_imports_without_pandas(module):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _BLOCK_PANDAS, module],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"imported {module}" in res.stdout
