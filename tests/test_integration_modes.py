"""Cross-mode integration: every engine configuration returns identical
results on the same data (dense / bitplane XLA / bitplane Pallas kernel,
folded or not, through the registry and server wiring)."""

import numpy as np
import pytest

from gpusimilarity_jax.models import DatabaseRegistry, FingerprintDB

from conftest import random_fingerprint_data


class TestModeParity:
    @pytest.fixture(scope="class")
    def data(self):
        return random_fingerprint_data(
            np.random.default_rng(77), count=20000, dbkey="m"
        )

    @pytest.fixture(scope="class")
    def expected(self, data):
        db = FingerprintDB(data, scan_mode="dense")
        words = data.packed_words()
        return [
            db.search(words[i], k=15, cutoff=c, dbkey="m")
            for i, c in ((0, 0.0), (9999, 0.15), (19999, 0.0))
        ]

    @pytest.mark.parametrize(
        "kwargs",
        [
            {"scan_mode": "bitplane", "use_pallas": True, "interpret": True},
            {"scan_mode": "bitplane"},
            {"scan_mode": "dense", "chunk_cols": 4096},
        ],
        ids=["pallas", "bitplane", "small-chunks"],
    )
    def test_all_modes_agree(self, data, expected, kwargs):
        db = FingerprintDB(data, **kwargs)
        words = data.packed_words()
        for (i, c), exp in zip(((0, 0.0), (9999, 0.15), (19999, 0.0)), expected):
            got = db.search(words[i], k=15, cutoff=c, dbkey="m")
            assert got.scores == exp.scores
            assert got.approximate_count == exp.approximate_count
            # ids may differ only at equal-score ties for bitplane flattening
            for gid, eid, gs, es in zip(got.ids, exp.ids, got.scores, exp.scores):
                if gid != eid:
                    assert gs == es  # a tie, by construction

    def test_fold2_near_exact(self, data, expected):
        """Folding is approximate by design (reference slide 11: 0% mismatch
        at fold 2 on real fingerprints); on random data demand the documented
        contract — self-match exact, vast majority of top-k recovered."""
        db = FingerprintDB(data, scan_mode="dense", fold_factor=2)
        words = data.packed_words()
        exp = expected[0]
        got = db.search(words[0], k=15, dbkey="m")
        assert got.scores[0] == 1.0 and got.ids[0] == exp.ids[0]
        # random data is adversarial for folding (thousands of near-ties in
        # the 0.10-0.13 band); the contract is bounded score degradation
        # per rank, not identity recovery
        assert got.scores[:3] == exp.scores[:3]
        for gs, es in zip(got.scores, exp.scores):
            assert es - gs < 0.015
        # every returned score is an exact full-width score
        for gid, gs in zip(got.ids, got.scores):
            if gid in exp.ids:
                assert gs == exp.scores[exp.ids.index(gid)]

    def test_server_with_socket_and_pallas(self, data, tmp_path):
        """SimilarityServer wiring: socket protocol + the bitplane Pallas
        kernel (interpreted) together."""
        import socket

        from gpusimilarity_jax.serve.server import SimilarityServer
        from gpusimilarity_jax.utils.fsim import read_fsim, write_fsim
        from tests_socket_helpers import encode_request, decode_response

        write_fsim(tmp_path / "m.fsim", data)
        reg = DatabaseRegistry()
        reg.add(
            "m", read_fsim(tmp_path / "m.fsim"), scan_mode="bitplane",
            use_pallas=True, interpret=True,
        )
        srv = SimilarityServer(
            reg, port=0, window_ms=1.0, socket_name="itest.sock"
        )
        srv.start_background()
        try:
            fp = data.fingerprints[42].tobytes()
            payload = encode_request([("m", "m")], 5, 3, 0.0, fp)
            c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            c.connect(srv.socket_server.path)
            c.sendall(payload)
            buf = b""
            c.settimeout(60)
            while True:
                buf += c.recv(65536)
                try:
                    rn, approx, smiles, ids, scores = decode_response(buf)
                    break
                except Exception:
                    continue
            c.close()
            assert rn == 5 and scores[0] == 1.0
            assert ids[0] == data.ids[42].decode()
        finally:
            srv.close()


class TestPallasBitplane:
    def test_pallas_bitplane_matches_xla(self):
        """Kernel parity with the XLA phase 1, in interpreter mode.

        A single-device mesh keeps every column on one shard, so the
        engine reaches the two-phase branch (and the kernel) at a size the
        interpreter runs quickly.
        """
        import jax

        from gpusimilarity_jax.parallel.mesh import make_mesh

        mesh = make_mesh(jax.devices()[:1])
        # 524288 cols: n_blocks=256 > the 128-candidate k_fetch bucket, so
        # the engine reaches the two-phase branch and the kernel
        # (262144 cols would land in the small-path shortcut)
        data = random_fingerprint_data(
            np.random.default_rng(5), count=524288, dbkey="pb"
        )
        xla = FingerprintDB(data, mesh=mesh, scan_mode="bitplane")
        pal = FingerprintDB(
            data, mesh=mesh, scan_mode="bitplane", use_pallas=True,
            interpret=True,
        )
        words = data.packed_words()
        from gpusimilarity_jax.parallel import sharded

        sharded.LAST_PHASE1_IMPL.clear()
        a = xla.search(words[31337], k=20, cutoff=0.1, dbkey="pb")
        b = pal.search(words[31337], k=20, cutoff=0.1, dbkey="pb")
        assert sharded.LAST_PHASE1_IMPL["bitplane"] == "pallas"
        assert a.scores == b.scores
        assert a.ids == b.ids
        assert a.approximate_count == b.approximate_count
        assert b.scores[0] == 1.0
