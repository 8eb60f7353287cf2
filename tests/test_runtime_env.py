"""Where the program runs: the compile-cache location rule
(utils/compile_cache.py) and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys

import pytest

from pointcloudprocessor_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**overrides):
    env = {k: v for k, v in os.environ.items() if k != compile_cache.ENV_VAR}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.update(overrides)
    return env


def test_cache_dir_follows_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    assert compile_cache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")


_COMPILE_ONE = """
import jax, jax.numpy as jnp
from pointcloudprocessor_tpu.utils import compile_cache
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
d = compile_cache.enable(min_compile_time_secs=0.0)
print(d)
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: jnp.sin(x) * 3.0 + {salt})(jnp.ones(7)).block_until_ready()
"""


def test_cache_files_appear_only_in_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, a compiled program lands there
    and the helper configures no other directory."""
    cache = tmp_path / "cache"
    before = set(os.listdir(compile_cache.DEFAULT_DIR)) if os.path.isdir(
        compile_cache.DEFAULT_DIR) else set()
    out = subprocess.run(
        [sys.executable, "-c", _COMPILE_ONE.format(salt=hash(str(tmp_path)) % 997)],
        env=_env(**{compile_cache.ENV_VAR: str(cache)}),
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout.split()
    assert out[0] == out[1] == str(cache)
    assert any(cache.iterdir()), "no cache entry written to the env dir"
    after = set(os.listdir(compile_cache.DEFAULT_DIR)) if os.path.isdir(
        compile_cache.DEFAULT_DIR) else set()
    assert after == before, "entries leaked into the checkout cache"


def test_cache_unset_uses_checkout_dir():
    out = subprocess.run(
        [sys.executable, "-c", _COMPILE_ONE.format(salt=1.5)],
        env=_env(), capture_output=True, text=True, timeout=300, check=True,
    ).stdout.split()
    assert out[0] == out[1] == os.path.join(ROOT, ".jax_cache")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu(tmp_path, alone):
    """On a machine without a GPU the smoke run exits non-zero and never
    claims success — from the checkout, and copied alone into an empty
    directory."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    env = _env()
    if alone:
        cwd = str(tmp_path)
        (tmp_path / "chip_smoke.py").write_text(open(script).read())
        script = str(tmp_path / "chip_smoke.py")
        env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr
