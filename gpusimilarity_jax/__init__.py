"""gpusimilarity_jax — brute-force chemical fingerprint search in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of
schrodinger/gpusimilarity: build fingerprint databases from SMILES libraries,
keep them resident in GPU memory sharded over a device mesh, and serve exact
Tanimoto/Tversky top-k similarity searches with cutoff filtering, fingerprint
folding, multi-database merging, and an HTTP/JSON front end.
"""

__version__ = "0.2.0"

from .utils.fsim import FingerprintData, read_fsim, write_fsim, merge_fsim  # noqa: F401
from .utils.fingerprints import (  # noqa: F401
    smiles_to_fingerprint_bin,
    generator_tag,
)
from .utils.smiles import canonical_smiles, parse_smiles  # noqa: F401

__all__ = [
    "FingerprintData",
    "read_fsim",
    "write_fsim",
    "merge_fsim",
    "smiles_to_fingerprint_bin",
    "generator_tag",
    "canonical_smiles",
    "parse_smiles",
    "__version__",
]
