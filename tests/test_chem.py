"""Tests for the built-in SMILES parser, canonical writer, and Morgan FPs."""

import os

import numpy as np
import pytest

from gpusimilarity_jax.utils.fingerprints import (
    BITCOUNT,
    FingerprintError,
    fingerprint_bin_to_words,
    smiles_to_fingerprint_bin,
    smiles_to_query_words,
)
from gpusimilarity_jax.utils.rdmorgan import morgan_bits, smiles_to_morgan_packed
from gpusimilarity_jax.utils.smiles import (
    SmilesError,
    canonical_smiles,
    parse_smiles,
    write_smiles,
)


class TestParser:
    def test_ethanol(self):
        m = parse_smiles("CCO")
        assert len(m.atoms) == 3
        assert [a.total_hs for a in m.atoms] == [3, 2, 1]
        assert len(m.bonds) == 2

    def test_benzene_aromatic(self):
        m = parse_smiles("c1ccccc1")
        assert len(m.atoms) == 6
        assert all(a.aromatic and a.in_ring for a in m.atoms)
        assert all(a.total_hs == 1 for a in m.atoms)
        assert all(b.aromatic for b in m.bonds)
        assert len(m.bonds) == 6

    def test_pyridine_nitrogen_no_h(self):
        m = parse_smiles("c1ccncc1")
        n_atom = next(a for a in m.atoms if a.symbol == "N")
        assert n_atom.total_hs == 0

    def test_pyrrole_bracket_nh(self):
        m = parse_smiles("[nH]1cccc1")
        n_atom = next(a for a in m.atoms if a.symbol == "N")
        assert n_atom.total_hs == 1 and n_atom.aromatic

    def test_charges(self):
        assert parse_smiles("[NH4+]").atoms[0].charge == 1
        assert parse_smiles("[O-]").atoms[0].charge == -1
        assert parse_smiles("[Fe+2]").atoms[0].charge == 2
        assert parse_smiles("[Fe++]").atoms[0].charge == 2

    def test_isotope(self):
        assert parse_smiles("[13CH4]").atoms[0].isotope == 13

    def test_bond_orders(self):
        m = parse_smiles("C=C")
        assert m.bonds[0].order == 2
        assert [a.total_hs for a in m.atoms] == [2, 2]
        m = parse_smiles("C#N")
        assert m.bonds[0].order == 3
        assert m.atoms[0].total_hs == 1 and m.atoms[1].total_hs == 0

    def test_branches_and_rings(self):
        m = parse_smiles("CC(C)(C)C")  # neopentane
        assert len(m.atoms) == 5
        center = m.atoms[1]
        assert m.degree(1) == 4 and center.total_hs == 0
        m = parse_smiles("C1CC1")
        assert all(a.in_ring for a in m.atoms)

    def test_percent_ring_closure(self):
        m1, m2 = parse_smiles("C1CC1"), parse_smiles("C%42CC%42")
        assert len(m1.bonds) == len(m2.bonds) == 3

    def test_two_letter_elements(self):
        m = parse_smiles("ClCCBr")
        assert m.atoms[0].symbol == "Cl" and m.atoms[-1].symbol == "Br"

    def test_disconnected_components(self):
        m = parse_smiles("CCO.[Na+]")
        assert len(m.atoms) == 4 and len(m.bonds) == 2

    def test_sulfur_valences(self):
        # sulfate-like hypervalent S with explicit bonds
        m = parse_smiles("O=S(=O)(O)O")
        s = next(a for a in m.atoms if a.symbol == "S")
        assert s.total_hs == 0

    def test_smiles_stops_at_whitespace(self):
        m = parse_smiles("CCO ZINC123")
        assert len(m.atoms) == 3

    @pytest.mark.parametrize(
        "bad",
        ["", "C(", "C)", "C1CC", "[C", "C%4", "Xx", "1CC", "[]", "C..C",
         # bond-symbols-only, dangling bond at end / before ')' / after '('
         "#-", "C=", "C(C=)O", "C=(C)O",
         # conflicting ring-closure bond orders; duplicate parallel bond
         "C-1CCCCC=1", "C12CC12"],
    )
    def test_malformed_raises(self, bad):
        with pytest.raises(SmilesError):
            parse_smiles(bad)


class TestCanonical:
    @pytest.mark.parametrize(
        "a,b",
        [
            ("CCO", "OCC"),
            ("Cc1ccccc1", "c1ccccc1C"),
            ("CC(C)C", "C(C)(C)C"),
            ("c1ccncc1", "n1ccccc1"),
            ("C1CC2CCC1CC2", "C2CC1CCC2CC1"),
            ("O=C(O)c1ccccc1", "c1ccccc1C(=O)O"),
        ],
    )
    def test_order_invariance(self, a, b):
        assert canonical_smiles(a) == canonical_smiles(b)

    def test_idempotent(self):
        for s in ("CCO", "c1ccc2ccccc2c1", "CC(=O)[O-]", "C1=CC=CC=C1"):
            c = canonical_smiles(s)
            assert canonical_smiles(c) == c

    def test_distinct_molecules_stay_distinct(self):
        assert canonical_smiles("CCO") != canonical_smiles("CCN")
        assert canonical_smiles("C1CC1") != canonical_smiles("CCC")

    def test_reference_fixture_corpus(self):
        """Every real ZINC SMILES in the reference fixture parses,
        canonicalizes idempotently, and fingerprints order-invariantly."""
        from gpusimilarity_jax.utils.fsim import read_fsim

        path = "/root/reference/test/small.fsim"
        if not os.path.exists(path):
            pytest.skip("reference fixture not available")
        data = read_fsim(path)
        for smi in data.smiles:
            s = smi.decode()
            c = canonical_smiles(s)
            assert canonical_smiles(c) == c
            assert smiles_to_morgan_packed(s) == smiles_to_morgan_packed(c)


class TestMorgan:
    def test_deterministic(self):
        assert smiles_to_morgan_packed("CCO") == smiles_to_morgan_packed("CCO")

    def test_order_invariant(self):
        assert smiles_to_morgan_packed("CCO") == smiles_to_morgan_packed("OCC")

    def test_different_molecules_differ(self):
        assert smiles_to_morgan_packed("CCO") != smiles_to_morgan_packed("CCCCO")

    def test_radius_zero_subset_of_radius_two(self):
        m = parse_smiles("CCO")
        b0 = morgan_bits(m, radius=0)
        b2 = morgan_bits(m, radius=2)
        assert (b2 >= b0).all()
        assert b2.sum() > b0.sum()

    def test_packed_width(self):
        fp = smiles_to_morgan_packed("c1ccccc1", nbits=1024)
        assert len(fp) == 128
        fp512 = smiles_to_morgan_packed("c1ccccc1", nbits=512)
        assert len(fp512) == 64

    def test_similar_molecules_share_more_bits(self):
        def tani(a, b):
            ab = np.frombuffer(a, np.uint8)
            bb = np.frombuffer(b, np.uint8)
            inter = np.unpackbits(ab & bb).sum()
            union = np.unpackbits(ab | bb).sum()
            return inter / union

        ethanol = smiles_to_morgan_packed("CCO")
        propanol = smiles_to_morgan_packed("CCCO")
        benzene = smiles_to_morgan_packed("c1ccccc1")
        assert tani(ethanol, propanol) > tani(ethanol, benzene)


class TestFingerprintFrontend:
    def test_smiles_to_fingerprint_bin(self):
        fp, canon = smiles_to_fingerprint_bin("OCC")
        assert len(fp) == BITCOUNT // 8
        assert canon == smiles_to_fingerprint_bin("CCO")[1]

    def test_bad_structure_raises(self):
        with pytest.raises(FingerprintError):
            smiles_to_fingerprint_bin("not a smiles (((")

    def test_query_words(self):
        words, canon = smiles_to_query_words("c1ccccc1")
        assert words.shape == (32,) and words.dtype == np.uint32
        assert isinstance(canon, str)

    def test_fingerprint_bin_to_words_width_check(self):
        with pytest.raises(ValueError):
            fingerprint_bin_to_words(b"\x00" * 5)

    def test_end_to_end_self_search(self, rng):
        """Full slice: SMILES -> fingerprints -> FingerprintData -> engine."""
        from gpusimilarity_jax.models import FingerprintDB
        from gpusimilarity_jax.utils.fsim import FingerprintData

        corpus = ["CCO", "CCCO", "c1ccccc1", "c1ccncc1", "CC(=O)O",
                  "CC(C)CC", "OCC(O)CO", "Clc1ccccc1"]
        fps, canons = [], []
        for s in corpus:
            fp, c = smiles_to_fingerprint_bin(s)
            fps.append(np.frombuffer(fp, np.uint8))
            canons.append(c)
        data = FingerprintData(
            fingerprints=np.stack(fps),
            smiles=canons,
            ids=[f"M{i}".encode() for i in range(len(corpus))],
        )
        db = FingerprintDB(data)
        q, _ = smiles_to_query_words("OCC")  # ethanol, reordered
        r = db.search(q, k=3)
        assert r.ids[0] == "M0" and r.scores[0] == 1.0


class TestAromaticityPerception:
    """Hückel aromatization of Kekulé-written rings (RDKit default model)."""

    @pytest.mark.parametrize(
        "kekule,aromatic",
        [
            ("C1=CC=CC=C1", "c1ccccc1"),  # benzene
            ("C1=CC=CC=N1", "c1ccncc1"),  # pyridine
            ("C1=CC=CN1", "c1cc[nH]c1"),  # pyrrole
            ("C1=CC=CO1", "c1ccoc1"),  # furan
            ("C1=CC=CS1", "c1ccsc1"),  # thiophene
            ("C1=CN=CN1", "c1c[nH]cn1"),  # imidazole
            ("C1=CC2=CC=CC=C2C=C1", "c1ccc2ccccc2c1"),  # naphthalene
            ("O=C1C=CC=CN1", "O=c1cccc[nH]1"),  # 2-pyridone
            ("[NH+]1=CC=CC=C1", "c1cc[nH+]cc1"),  # pyridinium
            ("C1=CC2=NC=CC=C2C=C1", "c1ccc2ncccc2c1"),  # quinoline-ish
        ],
    )
    def test_kekule_input_canonicalizes_to_aromatic_form(self, kekule, aromatic):
        assert canonical_smiles(kekule) == canonical_smiles(aromatic)

    @pytest.mark.parametrize(
        "smi",
        [
            "O=C1C=CC(=O)C=C1",  # quinone
            "C1=CC=CC1",  # cyclopentadiene (sp3 C)
            "C1=CC=CC=CC=C1",  # cyclooctatetraene (8 electrons)
            "C=C1C=CC=C1",  # fulvene
            "C1CCCCC1",  # cyclohexane
        ],
    )
    def test_antiaromatic_and_saturated_stay_nonaromatic(self, smi):
        m = parse_smiles(smi)
        assert not any(a.aromatic for a in m.atoms)
        assert not any(b.aromatic for b in m.bonds)

    @pytest.mark.parametrize(
        "mixed,pure",
        [
            ("c1ccc2c(c1)C=CC=C2", "c1ccc2ccccc2c1"),  # half-Kekulé naphthalene
            ("c1ccc2c(c1)C=CN2", "c1ccc2[nH]ccc2c1"),  # half-Kekulé indole
        ],
    )
    def test_mixed_form_input(self, mixed, pure):
        assert canonical_smiles(mixed) == canonical_smiles(pure)

    def test_tetralin_saturated_ring_stays(self):
        m = parse_smiles("c1ccc2c(c1)CCCC2")
        assert sum(a.aromatic for a in m.atoms) == 6

    def test_azulene_needs_fused_union(self):
        m = parse_smiles("C1=CC2=CC=CC=CC2=C1")
        assert all(a.aromatic for a in m.atoms)

    def test_biphenylene_bridges_stay_single(self):
        # the central 4-ring has 12 pi electrons (4n): NOT aromatic, even
        # though every atom sits in an aromatic 6-ring
        m = parse_smiles("C1=CC2=C(C=C1)C1=C2C=CC=C1")
        assert all(a.aromatic for a in m.atoms)
        non_arom = [b for b in m.bonds if b.in_ring and not b.aromatic]
        assert len(non_arom) == 2

    def test_kekulize_writer_roundtrip(self):
        from gpusimilarity_jax.utils.smiles import write_smiles

        for s in ("c1ccccc1", "c1cc[nH]c1", "c1ccc2ccccc2c1",
                  "O=c1cccc[nH]1", "c1cc[nH+]cc1"):
            kek = write_smiles(parse_smiles(s), kekule=True)
            assert "c" not in kek.replace("Cl", "")
            assert canonical_smiles(kek) == canonical_smiles(s)

    def test_unkekulizable_raises(self):
        from gpusimilarity_jax.utils.smiles import kekulized

        with pytest.raises(SmilesError):
            # 5 aromatic CH each needing a double bond: odd count, no
            # perfect matching exists
            kekulized(parse_smiles("c1cccc1"))

    def test_pathological_kekulize_terminates_fast(self):
        """Tangled nested ring-number-reuse input used to hang the naive
        backtracking matcher for minutes (round-2 review); component
        decomposition + forced moves + the work budget must finish it in
        well under a second either way."""
        import time

        from gpusimilarity_jax.utils.smiles import kekulized

        n = 40  # 240 atoms
        s = "c1ccc(" * (n - 1) + "c1ccccc1" + ")cc1" * (n - 1)
        t0 = time.monotonic()
        try:
            kekulized(parse_smiles(s))
        except SmilesError:
            pass  # a clean refusal is acceptable; hanging is not
        assert time.monotonic() - t0 < 5.0

    def test_26_annulene_aromatic(self):
        # 13 double bonds = 26 pi electrons = 4n+2: aromatic in the
        # electron-counting model (no ring-size cap)
        m = parse_smiles("C1" + "=CC" * 12 + "=C1")
        assert len(m.atoms) == 26
        assert all(a.aromatic for a in m.atoms)


class TestParserFuzz:
    def test_no_unexpected_exceptions(self):
        """Random garbage either parses or raises SmilesError — never
        crashes — and the writer handles anything the parser accepts."""
        import random

        rng = random.Random(42)
        alphabet = "CNOSPcnos()[]=#123456789+-@Hl rB%F\\/."
        parsed = 0
        for _ in range(3000):
            s = "".join(
                rng.choice(alphabet) for _ in range(rng.randint(1, 30))
            )
            try:
                mol = parse_smiles(s)
                write_smiles(mol)
                parsed += 1
            except SmilesError:
                continue
            try:  # kekulized output may legitimately fail (no matching)...
                kek = write_smiles(mol, kekule=True)
            except SmilesError:
                continue
            parse_smiles(kek)  # ...but what it writes must reparse
        assert parsed > 50  # sanity: some random strings are valid


class TestCanonicalPermutationInvariance:
    """The canonical SMILES must not depend on input atom order — tied but
    non-equivalent atoms used to fall back to input-index tie-breaks, so
    the same compound from two databases could fail cross-DB SMILES dedup
    (round-1 advisor finding)."""

    def _permuted(self, mol, perm):
        from gpusimilarity_jax.utils.smiles import Atom, Bond, Molecule
        import dataclasses

        inv = [0] * len(perm)
        for new, old in enumerate(perm):
            inv[old] = new
        atoms = []
        for new, old in enumerate(perm):
            a = dataclasses.replace(mol.atoms[old], index=new)
            atoms.append(a)
        bonds = [
            Bond(a1=inv[b.a1], a2=inv[b.a2], order=b.order,
                 aromatic=b.aromatic)
            for b in mol.bonds
        ]
        out = Molecule(atoms=atoms, bonds=bonds)
        for b_old, b_new in zip(mol.bonds, bonds):
            b_new.in_ring = getattr(b_old, "in_ring", False)
        return out

    @pytest.mark.parametrize(
        "smi",
        [
            "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O",  # ibuprofen
            "CC(=O)Oc1ccccc1C(=O)O",
            "C[NH+](C)CC(=O)N1c2ccccc2Sc2ccccc21",
            "OCC1OC(O)C(O)C(O)C1O",  # glucose-like
            "CCN(CC)C(=O)C1CN(C)C2CC3=CNc4cccc(C2=C1)c34",  # LSD-like
            "C1CC2CCC1CC2",  # bridged
            "CC1=CC(=O)C=CC1=O",
            # Frucht graph (cubic, trivial automorphism group): plain
            # refinement stalls with ALL atoms tied yet none equivalent —
            # the case where input-index tie-breaks gave order-dependent
            # output before the distance-profile invariants
            "C12C3C4C5C6C5C7C2C7C6C4C13",
        ],
    )
    def test_atom_order_invariant(self, smi):
        import random

        from gpusimilarity_jax.utils.smiles import (
            canonical_ranks, parse_smiles, write_smiles,
        )

        mol = parse_smiles(smi)
        base = write_smiles(mol)
        rng = random.Random(7)
        n = len(mol.atoms)
        for _ in range(8):
            perm = list(range(n))
            rng.shuffle(perm)
            pm = self._permuted(mol, perm)
            assert write_smiles(pm) == base, (smi, perm)
