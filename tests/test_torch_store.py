"""The PyTorch package's bounded-RAM query store (kmergutsjava_tpu_torch/
lookup/store.py) against the JAX package's: with spills and a merge
cascade, ``finalize`` gives the same records sorted by (home, value). Equal
keys may come in another order (the port's merge keeps the first file's
records first; the JAX merge's tie order depends on where the files
interleave), so records are compared as multisets ordered by every
field. The port's merge drains a whole buffer each round, so finely
interleaved files merge in time linear in their length."""
import time

import numpy as np
import pytest

from kmergutsjava_tpu.lookup.store import QueryKmerStore as JaxStore
from kmergutsjava_tpu_torch.lookup import store


def _records(rng, n, num_sigs, dup_every=0):
    values = rng.integers(0, 4 * num_sigs, n)
    if dup_every:
        values[::dup_every] = values[0]  # one key in every chunk
    return values, rng.integers(0, 9, n)


def _by_every_field(rec, num_sigs):
    v = rec["value"]
    return rec[np.lexsort((rec["pos"], rec["cnt"], v, v % num_sigs))]


def _assert_sorted(rec, num_sigs):
    h, v = rec["value"] % num_sigs, rec["value"]
    assert np.all((h[1:] > h[:-1]) | ((h[1:] == h[:-1]) & (v[1:] >= v[:-1])))


@pytest.mark.parametrize("n,limit,batch,dup_every",
                         [(20_000, 3_000, 700, 0), (9_000, 1_000, 333, 5),
                          (5_000, 10**9, 500, 0), (4_000, 4_000, 4_000, 3)])
def test_store_matches_jax_store(tmp_path, n, limit, batch, dup_every):
    num_sigs = 1_777
    rng = np.random.default_rng(n + limit)
    values, cnt = _records(rng, n, num_sigs, dup_every)
    got, want = [], []
    for cls, out, sub in ((store.QueryKmerStore, got, "port"),
                          (JaxStore, want, "jax")):
        d = tmp_path / sub
        d.mkdir()
        s = cls(num_sigs, limit, str(d))
        for at in range(0, n, batch):
            s.add_batch(values[at:at + batch], int(cnt[at]),
                        np.arange(at, min(at + batch, n)))
        rec = np.array(s.finalize(require_sorted=True))
        s.close()
        out.append(rec)
    (a,), (b,) = got, want
    assert len(a) == n
    _assert_sorted(a, num_sigs)
    assert (_by_every_field(a, num_sigs).tobytes()
            == _by_every_field(b, num_sigs).tobytes())


def test_merge_keeps_first_file_first_on_equal_keys(tmp_path):
    num_sigs = 10
    a = np.zeros(6, dtype=store.REC_DTYPE)
    b = np.zeros(5, dtype=store.REC_DTYPE)
    a["value"], a["pos"] = [3, 5, 5, 5, 15, 25], np.arange(6)
    b["value"], b["pos"] = [5, 5, 15, 15, 7], 100 + np.arange(5)
    a, b = store.sort_records(a, num_sigs), store.sort_records(b, num_sigs)
    a.tofile(tmp_path / "a")
    b.tofile(tmp_path / "b")
    for block in (1, 2, 3, 100):
        out = tmp_path / f"out{block}"
        store.merge_two_sorted_files(str(tmp_path / "a"), str(tmp_path / "b"),
                                     str(out), num_sigs, block=block)
        m = np.fromfile(out, dtype=store.REC_DTYPE)
        assert m["value"].tolist() == [3, 5, 5, 5, 5, 5, 15, 15, 15, 25, 7]
        assert m["pos"].tolist() == [0, 1, 2, 3, 100, 101, 4, 102, 103, 5,
                                     104]


def test_merge_of_finely_interleaved_files_is_fast(tmp_path):
    """400,000 and 50,000 random records alternate every few records; the
    cut-by-head merge this replaced took minutes on such files."""
    num_sigs = 1_000_003
    rng = np.random.default_rng(3)
    files = []
    for name, n in (("a", 400_000), ("b", 50_000)):
        rec = np.zeros(n, dtype=store.REC_DTYPE)
        rec["value"] = rng.integers(0, 20 * num_sigs, n)
        rec["pos"] = np.arange(n)
        store.sort_records(rec, num_sigs).tofile(tmp_path / name)
        files.append(str(tmp_path / name))
    t0 = time.time()
    store.merge_two_sorted_files(*files, str(tmp_path / "out"), num_sigs)
    assert time.time() - t0 < 20
    m = np.fromfile(tmp_path / "out", dtype=store.REC_DTYPE)
    assert len(m) == 450_000
    _assert_sorted(m, num_sigs)
