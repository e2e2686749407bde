"""``chip_smoke.py``'s oracle and response checks, on a tiny in-memory
library (the script itself needs a GPU)."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from gpusimilarity_jax.models.results import SearchResult  # noqa: E402
from gpusimilarity_jax.ops.scan import scores_np  # noqa: E402
from gpusimilarity_jax.utils import synth  # noqa: E402

N = 5000
SEED = 3


@pytest.fixture(scope="module")
def words():
    return synth.VirtualWords(N, 32, SEED)


@pytest.fixture(scope="module")
def full(words):
    return words[0:N]


def good_payload(full, row, k, cutoff):
    s = scores_np(full, full[row][None, :])[0]
    order = np.lexsort((np.arange(N), -s))[:k]
    order = order[s[order] >= np.float32(cutoff)]
    return {
        "approximate_count": int((s >= np.float32(cutoff)).sum()),
        "results": [[f"{i:010d}", f"{i:010d}", float(s[i])] for i in order],
        "query": "",
    }


@pytest.mark.parametrize("n", [1, 9999, 10000, 123457])
def test_id_blob(n):
    blob = cs.id_blob(n)
    assert blob.shape == (n, cs.ID_WIDTH)
    for row in {0, n // 2, n - 1}:
        assert blob[row].tobytes() == f"{row:010d}".encode()


def test_id_digits_at_a_billion_rows():
    rows = np.array([1_020_017_471, 999_999_999])
    assert cs._digits(rows, cs.ID_WIDTH).tobytes() == b"10200174710999999999"


@pytest.mark.parametrize("row,k,cutoff", [(0, 20, 0.0), (4999, 128, 0.3)])
def test_correct_response_passes(words, full, row, k, cutoff):
    assert cs.response_errors(good_payload(full, row, k, cutoff), words,
                              row, k, cutoff) == []


def _swap_first_two(p):
    p["results"][0], p["results"][1] = p["results"][1], p["results"][0]


def _wrong_score(p):
    p["results"][3][2] = np.nextafter(np.float32(p["results"][3][2]),
                                      np.float32(1)).item()


def _other_row(p):
    p["results"][2][0] = "0000000001"


def _drop_key(p):
    del p["approximate_count"]


def _bad_id(p):
    p["results"][0][0] = "SYN-1"


def _low_count(p):
    p["approximate_count"] = 1


@pytest.mark.parametrize(
    "corrupt",
    [_swap_first_two, _wrong_score, _other_row, _drop_key, _bad_id, _low_count],
)
def test_wrong_response_is_caught(words, full, corrupt):
    payload = good_payload(full, 17, 20, 0.0)
    corrupt(payload)
    assert cs.response_errors(payload, words, 17, 20, 0.0)


def test_too_many_results_caught(words, full):
    payload = good_payload(full, 17, 20, 0.0)
    assert cs.response_errors(payload, words, 17, 10, 0.0)


def test_host_oracle_matches_numpy(words, full):
    rows = [11, 4321]
    cutoffs = (0.0, 0.2, 0.3)
    top, counts = cs.host_oracle(
        N, SEED, words[np.array(rows)], 50, cutoffs, chunk=1024, workers=2
    )
    for qi, row in enumerate(rows):
        s = scores_np(full, full[row][None, :])[0]
        np.testing.assert_array_equal(top[qi], np.sort(s)[::-1][:50])
        assert list(counts[qi]) == [int((s >= np.float32(c)).sum())
                                    for c in cutoffs]


@pytest.mark.parametrize("corrupt", [None, "score", "drop", "count"])
def test_oracle_mismatches(full, corrupt):
    payload = good_payload(full, 42, 20, 0.3)
    s = scores_np(full, full[42][None, :])[0]
    top = np.sort(s)[::-1][:128]
    count = int((s >= np.float32(0.3)).sum())
    if corrupt == "score":
        payload["results"][1][2] = payload["results"][0][2]
    elif corrupt == "drop":
        payload["results"].pop()
    elif corrupt == "count":
        payload["approximate_count"] += 1
    errs = cs.oracle_mismatches(payload, top, 20, 0.3, count)
    assert bool(errs) == (corrupt is not None)


@pytest.mark.parametrize("similarity,ab", [
    ("tanimoto", (1.0, 1.0)), ("tversky", (0.75, 0.25)), ("tversky", (0.3, 0.9)),
])
def test_oracle_scores_matches_scores_np(full, similarity, ab):
    pops = np.bitwise_count(full).sum(axis=1, dtype=np.int64)
    for row in (0, 999):
        np.testing.assert_array_equal(
            cs.oracle_scores(full, pops, full[row], similarity, *ab),
            scores_np(full, full[row][None, :], similarity, *ab)[0],
        )


def _result(s, k, cutoff, shift_ulp=0):
    order = np.lexsort((np.arange(len(s)), -s))[:k]
    order = order[s[order] >= np.float32(cutoff)]
    scores = s[order].astype(np.float32)
    if shift_ulp:
        scores = (scores.view(np.int32) + shift_ulp).view(np.float32)
    r = SearchResult(scores=[float(x) for x in scores],
                     approximate_count=int((s >= np.float32(cutoff)).sum()))
    r.indices = order.tolist()
    return r


@pytest.mark.parametrize("similarity", ["tanimoto", "tversky"])
def test_oracle_errors(full, similarity):
    ab = (1.0, 1.0) if similarity == "tanimoto" else (0.75, 0.25)
    pops = np.bitwise_count(full).sum(axis=1, dtype=np.int64)
    oracle = [cs.oracle_scores(full, pops, full[r], similarity, *ab)
              for r in (5, 6)]
    cut = [0.0, 0.2]
    ok = [_result(oracle[i], 30, cut[i]) for i in range(2)]
    assert cs.oracle_errors(ok, oracle, cut, 30, similarity, True) == 0
    one_ulp = [_result(oracle[i], 30, cut[i], shift_ulp=1) for i in range(2)]
    errs = cs.oracle_errors(one_ulp, oracle, cut, 30, similarity, True)
    # Tanimoto is bit-exact; Tversky may sit 1 ulp off the oracle
    assert (errs == 0) == (similarity == "tversky")
    two_ulp = [_result(oracle[i], 30, cut[i], shift_ulp=2) for i in range(2)]
    assert cs.oracle_errors(two_ulp, oracle, cut, 30, similarity, True) > 0


def test_write_library_round_trip(tmp_path):
    from gpusimilarity_jax.utils.tfsim import load_any

    cs.write_library(str(tmp_path / "s.tfsim"), 3000, seed=SEED)
    data = load_any(str(tmp_path / "s.tfsim"))
    assert data.count == 3000 and data.dbkey == "smoke"
    assert data.ids[2999] == b"0000002999" == data.smiles[2999]
    np.testing.assert_array_equal(
        data.packed_words()[[0, 2999]],
        synth.virtual_rows_np(np.array([0, 2999]), seed=SEED),
    )


def test_main_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(cs.shutil, "which", lambda name: None)
    assert cs.main([]) == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": False}
