"""RDKit bit-exactness tests for the built-in Morgan implementation.

The reference fixture ``/root/reference/test/small.fsim`` stores 100 real
ZINC compounds whose 1024-bit Morgan fingerprints were generated by RDKit
(``gpusim_utils.py:55-66``: ``GetMorganFingerprintAsBitVect(mol, 2, 1024)``).
Those stored bits are the oracle: ``rdmorgan.morgan_bits`` must reproduce
every one of them exactly from the stored canonical SMILES.
"""

import os

import numpy as np
import pytest

from gpusimilarity_jax.utils.rdmorgan import (
    hash_combine,
    hash_range,
    morgan_bits,
    pack_bits,
    smiles_to_morgan_packed,
)
from gpusimilarity_jax.utils.smiles import parse_smiles

FIXTURE = "/root/reference/test/small.fsim"


def _digit(d: int) -> str:
    return str(d) if d < 10 else f"%{d:02d}"


def _golden():
    from gpusimilarity_jax.utils.fsim import read_fsim

    if not os.path.exists(FIXTURE):
        pytest.skip("reference small.fsim fixture not available")
    data = read_fsim(FIXTURE)
    packed = np.frombuffer(data.fingerprints, dtype=np.uint8).reshape(
        data.count, data.bitcount // 8
    )
    bits = np.unpackbits(packed, axis=1, bitorder="little")
    return [s.decode() for s in data.smiles], bits


class TestHash:
    def test_combine_is_32_bit(self):
        assert 0 <= hash_combine(0xFFFFFFFF, 0xFFFFFFFF) <= 0xFFFFFFFF

    def test_combine_formula(self):
        # seed ^ (v + 0x9e3779b9 + (seed<<6) + (seed>>2)) mod 2^32
        seed, v = 0x12345678, 0x9ABCDEF0
        expected = (
            seed
            ^ ((v + 0x9E3779B9 + ((seed << 6) & 0xFFFFFFFF) + (seed >> 2))
               & 0xFFFFFFFF)
        ) & 0xFFFFFFFF
        assert hash_combine(seed, v) == expected

    def test_range_order_sensitive(self):
        assert hash_range([1, 2]) != hash_range([2, 1])


class TestGoldenFixture:
    def test_all_100_fingerprints_bit_exact(self):
        """Every RDKit-generated fingerprint in the reference fixture is
        reproduced bit-for-bit from its canonical SMILES."""
        smiles, golden = _golden()
        mismatches = []
        for i, smi in enumerate(smiles):
            mine = morgan_bits(parse_smiles(smi))
            if not np.array_equal(mine, golden[i]):
                extra = int((mine & ~golden[i]).sum())
                missing = int((~mine & golden[i]).sum())
                mismatches.append(f"#{i} {smi}: +{extra}/-{missing} bits")
        assert not mismatches, "\n".join(mismatches)

    def test_kekulized_roundtrip_bit_exact(self):
        """Kekulé-written input must fingerprint identically: kekulize
        every fixture molecule (concrete bond orders, no aromatic flags),
        reparse it through aromaticity perception, and require the same
        RDKit-exact bits. Covers the Hückel model end to end on 100 real
        drug-like aromatic systems."""
        import re

        from gpusimilarity_jax.utils.smiles import write_smiles

        smiles, golden = _golden()
        mismatches = []
        for i, smi in enumerate(smiles):
            kek = write_smiles(parse_smiles(smi), kekule=True)
            # the kekulized string must contain no aromatic atoms at all
            assert not re.search(
                r"[cnosp]", kek.replace("Cl", "Q").replace("Br", "R")
            ), kek
            mine = morgan_bits(parse_smiles(kek))
            if not np.array_equal(mine, golden[i]):
                mismatches.append(f"#{i} {smi} -> {kek}")
        assert not mismatches, "\n".join(mismatches)

    def test_packed_layout_matches_fsim(self):
        """pack_bits emits the byte/bit layout .fsim files store."""
        from gpusimilarity_jax.utils.fsim import read_fsim

        smiles, _ = _golden()
        data = read_fsim(FIXTURE)
        raw = np.frombuffer(data.fingerprints, dtype=np.uint8)[:128].tobytes()
        assert pack_bits(morgan_bits(parse_smiles(smiles[0]))) == raw


class TestRegeneratedGoldenTables:
    def test_cutoff_tables_hold_on_regenerated_db(self, rng):
        """Rebuild the fixture database from its SMILES with the built-in
        generator and require the reference test suite's exact golden
        cutoff tables ({0,.1,.3,.4} -> {10,10,3,1} results /
        {100,86,3,1} approximate counts, ``test_gpusim.cpp:101-128``) —
        they can only hold if every regenerated fingerprint is
        bit-identical to RDKit's."""
        from gpusimilarity_jax.models import FingerprintDB
        from gpusimilarity_jax.utils.fingerprints import (
            smiles_to_fingerprint_bin,
        )
        from gpusimilarity_jax.utils.fsim import FingerprintData, read_fsim

        if not os.path.exists(FIXTURE):
            pytest.skip("reference small.fsim fixture not available")
        ref = read_fsim(FIXTURE)
        fps = []
        for s in ref.smiles:
            fp, _ = smiles_to_fingerprint_bin(s.decode())
            fps.append(np.frombuffer(fp, np.uint8))
        data = FingerprintData(
            dbkey="pass", fingerprints=np.stack(fps),
            smiles=list(ref.smiles), ids=list(ref.ids),
        )
        db = FingerprintDB(data)
        query = db.get_fingerprint(0)
        for cutoff, expect_n, expect_approx in (
            (0.0, 10, 100), (0.1, 10, 86), (0.3, 3, 3), (0.4, 1, 1)
        ):
            r = db.search(query, k=10, cutoff=cutoff, dbkey="pass")
            assert len(r) == expect_n
            assert r.approximate_count == expect_approx


class TestNativeChemParity:
    """native/tsn_chem.cpp must be byte-equivalent to the Python stack."""

    def _native(self):
        from gpusimilarity_jax.utils import native

        if not native.available():
            pytest.skip("native library not available")
        return native

    def _py(self, smi):
        from gpusimilarity_jax.utils.smiles import (
            SmilesError, parse_smiles, write_smiles,
        )

        try:
            mol = parse_smiles(smi)
            return pack_bits(morgan_bits(mol)), write_smiles(mol).encode()
        except SmilesError:
            return None

    def _nat(self, native, smi):
        try:
            return native.smiles_fingerprint(smi)
        except ValueError:
            return None

    def test_fixture_corpus_identical(self):
        native = self._native()
        smiles, _ = _golden()
        for smi in smiles:
            assert self._nat(native, smi) == self._py(smi), smi

    def test_fuzz_identical(self):
        import random

        native = self._native()
        rng = random.Random(99)
        alphabet = "CNOSPcnos()[]=#123456789+-@Hl rB%F\\/."
        for _ in range(1500):
            s = "".join(
                rng.choice(alphabet) for _ in range(rng.randint(1, 30))
            )
            assert self._nat(native, s) == self._py(s), repr(s)

    def test_edge_divergence_cases(self):
        """Inputs a round-2 adversarial review proved divergent (or
        crashing) between the two pipelines; both must now agree."""
        native = self._native()
        many_rings = (
            "C" + "".join(_digit(d) for d in range(100))
            + "C" + "".join(_digit(d) for d in range(100))
        )
        cases = [
            "[s]", "[c]", "[n]", "c1ccc[s]1", "C[n]C",  # lone-aromatic brackets
            "[99999999999999999999C]",  # unbounded isotope digits
            "[C+++++++++++]", "[C+999999999999]",  # charge runs
            "\x0cCC", "\x0bCC", "\x0c", "CC\x0c ID",  # exotic whitespace
            many_rings,  # >99 simultaneously open ring closures
            "[2H]O[2H]", "[se]1cccc1",
            "C-1CCCCC=1", "C12CC12",  # ring-order conflict / duplicate bond
            "C=1CCCCC=1", "C1CCCCC=1",  # consistent/one-sided orders: valid
        ]
        for smi in cases:
            assert self._nat(native, smi) == self._py(smi), repr(smi)

    def test_front_end_uses_native(self):
        from gpusimilarity_jax.utils.fingerprints import (
            HAVE_RDKIT, smiles_to_fingerprint_bin,
        )

        native = self._native()
        if HAVE_RDKIT:
            pytest.skip("RDKit path active")
        fp, canon = smiles_to_fingerprint_bin("c1ccccc1C(=O)O")
        assert (fp, canon) == native.smiles_fingerprint("c1ccccc1C(=O)O")


class TestRDKitSemantics:
    """Unit checks of the RDKit rules that round 1's generator missed."""

    def test_thiophene_sulfur_no_implicit_h(self):
        m = parse_smiles("c1ccsc1")
        s = next(a for a in m.atoms if a.symbol == "S")
        assert s.total_hs == 0  # aromatic atoms cap at the default valence

    def test_fusion_carbon_no_h(self):
        m = parse_smiles("c1ccc2ccccc2c1")  # naphthalene
        hs = sorted(a.total_hs for a in m.atoms)
        assert hs == [0, 0, 1, 1, 1, 1, 1, 1, 1, 1]

    def test_directional_ring_bond_is_aromatic(self):
        # stereo slash on an aromatic ring bond (fixture compound #1 shape)
        m = parse_smiles("c1ccc2[nH]/c(=N\\C)[nH]c2c1")
        ring_bonds = [b for b in m.bonds if b.direction]
        assert ring_bonds and all(b.aromatic for b in ring_bonds if b.in_ring)

    def test_explicit_hydrogen_atoms_fold_in(self):
        # [H]-written hydrogens merge into the heavy atom like RDKit's
        # default H removal; isotopic hydrogens stay graph atoms
        m = parse_smiles("[H]C([H])([H])[H]")
        assert len(m.atoms) == 1 and m.atoms[0].total_hs == 4
        assert smiles_to_morgan_packed("[H]C([H])([H])[H]") == (
            smiles_to_morgan_packed("C")
        )
        d = parse_smiles("[2H]C")
        assert len(d.atoms) == 2  # deuterium kept

    def test_charge_enters_invariant(self):
        assert smiles_to_morgan_packed("C[NH3+]") != smiles_to_morgan_packed(
            "CN"
        )

    def test_isotope_enters_invariant(self):
        assert smiles_to_morgan_packed("[2H]C") != smiles_to_morgan_packed(
            "[3H]C"
        )
        # 13C is within 1 amu of carbon's standard weight: deltaMass == 0,
        # so (like RDKit) it does NOT change the fingerprint
        assert smiles_to_morgan_packed("[13CH4]") == smiles_to_morgan_packed(
            "C"
        )
        # 11C sits on a knife edge: int(11.0114 - 12.011) truncates to 0,
        # not -1 — needs the exact isotope mass, not the mass number
        # (round-2 review finding; PET-tracer chemistry)
        assert smiles_to_morgan_packed("[11CH4]") == smiles_to_morgan_packed(
            "C"
        )
        assert smiles_to_morgan_packed("[14CH4]") != smiles_to_morgan_packed(
            "C"
        )

    def test_generator_tags_compatible(self):
        from gpusimilarity_jax.utils.fingerprints import (
            compatible_generators,
        )

        assert "rdkit-morgan-r2-1024" in compatible_generators(
            "rdkit-compat-morgan-r2-1024"
        )
        assert "builtin-morgan-r2-1024" not in compatible_generators(
            "rdkit-compat-morgan-r2-1024"
        )
        assert compatible_generators("") == frozenset({""})
