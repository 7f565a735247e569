"""Test harness config.

Tests run on CPU with 8 virtual devices so multi-device sharding paths
are exercised without a GPU.  Tests marked ``gpu`` run their device work
in a child process that sees the real platform; the ``gpu_env`` fixture
skips them where JAX finds no GPU.  On a GPU host:
``python -m pytest -m gpu tests/``.
"""

import os
import subprocess
import sys

_ENV0 = dict(os.environ)      # before the CPU pin below: for gpu tests
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def gpu_env():
    """Environment for a child process on the real platform; skips the
    test unless JAX there finds a GPU."""
    env = {k: v for k, v in _ENV0.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.returncode != 0 or probe.stdout.strip() != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX here finds "
                    f"{probe.stdout.strip() or 'no device'}")
    return env


@pytest.fixture(scope="session")
def small_corpus_text():
    from golden.corpus_gen import small_corpus
    return small_corpus()


@pytest.fixture(scope="session")
def zipf_corpus_text():
    from golden.corpus_gen import zipf_corpus
    return zipf_corpus()


@pytest.fixture(scope="session")
def small_corpus_file(tmp_path_factory, small_corpus_text):
    p = tmp_path_factory.mktemp("corpus") / "small.txt"
    p.write_text(small_corpus_text)
    return str(p)


@pytest.fixture(scope="session")
def zipf_corpus_file(tmp_path_factory, zipf_corpus_text):
    p = tmp_path_factory.mktemp("corpus") / "zipf.txt"
    p.write_text(zipf_corpus_text)
    return str(p)
