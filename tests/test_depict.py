"""2-D depiction: layout sanity and SVG output (debug-UI depictions)."""

import math

import pytest

from gpusimilarity_jax.utils.depict import find_rings, layout, mol_to_svg, smiles_to_svg
from gpusimilarity_jax.utils.smiles import parse_smiles

CASES = [
    "CCO",
    "c1ccccc1",
    "Cc1ccccc1",
    "c1ccc2ccccc2c1",  # fused bicycle
    "c1ccc2c(c1)ccc1ccccc12",  # three fused rings
    "CC(=O)Oc1ccccc1C(=O)O",  # aspirin
    "C[NH+](C)CC(=O)N1c2ccccc2Sc2ccccc21",  # fixture compound
    "C1CC2(CC1)CCCC2",  # spiro
    "N#Cc1ccccc1",
    "OCC(O)CO",
]


class TestLayout:
    @pytest.mark.parametrize("smi", CASES)
    def test_bond_lengths_and_no_overlaps(self, smi):
        mol = parse_smiles(smi)
        pos = layout(mol)
        assert len(pos) == len(mol.atoms)
        for b in mol.bonds:
            (x1, y1), (x2, y2) = pos[b.a1], pos[b.a2]
            assert 0.5 < math.hypot(x2 - x1, y2 - y1) < 2.0, smi
        for i in range(len(pos)):
            for j in range(i + 1, len(pos)):
                d = math.hypot(pos[i][0] - pos[j][0], pos[i][1] - pos[j][1])
                assert d > 0.3, (smi, i, j)

    def test_ring_finder_benzene_naphthalene(self):
        assert [len(r) for r in find_rings(parse_smiles("c1ccccc1"))] == [6]
        rings = find_rings(parse_smiles("c1ccc2ccccc2c1"))
        assert sorted(len(r) for r in rings) == [6, 6]


class TestSvg:
    @pytest.mark.parametrize("smi", CASES)
    def test_svg_renders(self, smi):
        svg = smiles_to_svg(smi)
        assert svg.startswith("<svg") and svg.endswith("</svg>")
        assert "<line" in svg

    def test_heteroatom_labels(self):
        svg = mol_to_svg(parse_smiles("CCO"))
        assert ">OH</text>" in svg
        svg = mol_to_svg(parse_smiles("C[NH+](C)C"))
        assert "NH+" in svg

    def test_aromatic_circle(self):
        assert "<circle" in smiles_to_svg("c1ccccc1")

    def test_bad_smiles_empty(self):
        assert smiles_to_svg("not_a_molecule((((") == ""

    def test_disconnected_salt(self):
        svg = smiles_to_svg("[Na+].[Cl-]")
        assert svg.startswith("<svg")


class TestServerHtml:
    def test_results_page_has_depictions(self):
        from gpusimilarity_jax.models import DatabaseRegistry
        from gpusimilarity_jax.serve.server import SearchService
        from test_server import corpus_data

        reg = DatabaseRegistry()
        reg.add("c", corpus_data())
        svc = SearchService(reg, window_ms=1.0)
        try:
            payload = svc.handle_search({"smiles": "CCO", "dbnames": "c"})
            page = svc.results_html(payload)
        finally:
            svc.close()
        assert page.count("<svg") >= len(payload["results"])  # + query
        assert "Query:" in page
