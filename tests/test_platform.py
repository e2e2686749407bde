"""Platform rules: the scan mode chosen per backend, the compile-cache
location, and the server's refusal to fall back to the CPU."""

import os
import subprocess
import sys

import pytest

from gpusimilarity_jax.models.registry import resolve_scan_mode
from gpusimilarity_jax.utils import jax_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "backend,fold,scan_mode,expected",
    [
        ("gpu", 1, "auto", "bitplane"),
        ("gpu", 2, "auto", "dense"),
        ("gpu", 8, "auto", "dense"),
        ("cpu", 1, "auto", "dense"),
        ("cpu", 1, "bitplane", "bitplane"),  # an explicit mode stays
        ("gpu", 4, "bitplane", "bitplane"),
    ],
)
def test_auto_scan_mode(backend, fold, scan_mode, expected):
    assert resolve_scan_mode(scan_mode, fold, backend) == expected


@pytest.mark.parametrize("backend", ["rocm", "metal", ""])
def test_unknown_backend_raises(backend):
    """No device is assumed: a backend without a rule is an error."""
    with pytest.raises(ValueError, match="backend"):
        resolve_scan_mode("auto", 1, backend)
    with pytest.raises(ValueError, match="backend"):
        resolve_scan_mode("dense", 1, backend)


@pytest.mark.parametrize("scan_mode", ["dense", "bitplane"])
def test_kernel_follows_platform(scan_mode):
    """The bitplane kernel is chosen by the mesh's platform, not a flag: a
    CPU mesh runs the XLA phase 1 in either mode."""
    import numpy as np

    from gpusimilarity_jax.models import FingerprintDB
    from gpusimilarity_jax.utils.fsim import FingerprintData

    fps = np.random.default_rng(0).integers(0, 256, (64, 32), np.uint8)
    data = FingerprintData(
        dbkey="", bitcount=256, fingerprints=fps,
        smiles=[b"C"] * 64, ids=[b"x"] * 64,
    )
    db = FingerprintDB(data, scan_mode=scan_mode)
    assert db.use_pallas is False


def test_server_has_no_kernel_flag():
    from gpusimilarity_jax.cli.server import parse_args

    with pytest.raises(SystemExit):
        parse_args(["lib.fsim", "--pallas"])


def test_cache_env_var_wins(monkeypatch, tmp_path):
    import jax

    updates = {}
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.update({k: v}))
    assert jax_cache.enable() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in updates  # JAX reads the env


def test_cache_default_is_in_checkout(monkeypatch):
    import jax

    updates = {}
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.update({k: v}))
    path = jax_cache.enable(min_compile_time_s=2.0)
    assert path == os.path.join(REPO, ".jax_cache")
    assert updates == {
        "jax_compilation_cache_dir": path,
        "jax_persistent_cache_min_compile_time_secs": 2.0,
    }


def test_only_the_helper_sets_a_cache_dir():
    """Every entry point goes through utils/jax_cache.py."""
    out = subprocess.run(
        ["git", "grep", "-l", "jax_compilation_cache_dir", "--", "*.py"],
        cwd=REPO, capture_output=True, text=True,
    )
    if out.returncode not in (0, 1):
        pytest.skip("not a git checkout")
    files = set(out.stdout.split())
    assert files <= {
        "gpusimilarity_jax/utils/jax_cache.py", "tests/test_platform.py"
    }, files


def test_server_refuses_cpu_without_flag(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "gpusimilarity_jax.cli.server",
         str(tmp_path / "absent.fsim"), "--port", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 2
    assert "--cpu_only" in out.stderr
