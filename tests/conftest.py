"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Mirrors the reference's no-hardware CI story (``SKIP_CUDA=1 ctest``,
reference ``.travis.yml:15-21``): the whole suite must pass without a GPU.
We force the CPU platform and fake 8 local devices so every sharding test
exercises real multi-device code paths; the Pallas kernel runs through the
Pallas interpreter (``interpret=True``). Must run before jax initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags += " --xla_force_host_platform_device_count=8"
if "xla_cpu_enable_fast_math" not in _flags:
    # IEEE-exact f32 division so similarity scores (small-int ratios) are
    # correctly rounded, matching the reference's CUDA float division.
    _flags += " --xla_cpu_enable_fast_math=false"
os.environ["XLA_FLAGS"] = _flags.strip()

import jax  # noqa: E402

from gpusimilarity_jax.utils import jax_cache  # noqa: E402

# Cache compilations on disk so repeated suite runs skip XLA compile time.
jax_cache.enable(min_compile_time_s=0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_FSIM = "/root/reference/test/small.fsim"


@pytest.fixture(scope="session")
def reference_fixture_path():
    """Path to the reference repo's golden fixture, if mounted."""
    if not os.path.exists(REFERENCE_FSIM):
        pytest.skip("reference small.fsim fixture not available")
    return REFERENCE_FSIM


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xF1D0)


def random_fingerprint_data(rng, count=100, bitcount=1024, density=0.1, dbkey=""):
    """Synthetic FingerprintData with ~density bits set per fingerprint."""
    from gpusimilarity_jax.utils.fsim import FingerprintData

    bits = rng.random((count, bitcount)) < density
    packed = np.packbits(bits, axis=1, bitorder="little")
    smiles = [f"C{'C' * (i % 7)}N{i}".encode() for i in range(count)]
    ids = [f"TEST{i:08d}".encode() for i in range(count)]
    return FingerprintData(
        dbkey=dbkey, bitcount=bitcount, fingerprints=packed, smiles=smiles, ids=ids
    )


@pytest.fixture()
def small_synthetic(rng):
    return random_fingerprint_data(rng)
