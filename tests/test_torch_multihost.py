"""The multi-host contract of the port (kmergutsjava_tpu_torch/parallel/
multihost.py), as tests/test_multihost.py holds the JAX package's:
round-robin record sharding over N simulated hosts gives per-record report
blocks identical to a single run, and merge_report_shards rebuilds the
single run's bytes (here also the JAX engine's); plus the arguments
initialize_distributed refuses."""
import io
import random
import re

import pytest

from kmergutsjava_tpu.config import EngineConfig as JaxConfig
from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine
from kmergutsjava_tpu.parallel import multihost as jax_multihost
from kmergutsjava_tpu_torch.config import EngineConfig
from kmergutsjava_tpu_torch.formats.fasta import FastaRecord
from kmergutsjava_tpu_torch.formats.table_tools import (signatures_from_proteins,
                                                        write_data_dir)
from kmergutsjava_tpu_torch.models.pipeline import Engine
from kmergutsjava_tpu_torch.parallel.multihost import (initialize_distributed,
                                                       merge_report_shards,
                                                       shard_records,
                                                       split_report_blocks)

AA = "ACDEFGHIKLMNPQRSTVWY"
CODON = {  # one codon per aa, for building DNA that translates cleanly
    "A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
    "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
    "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
    "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}


def _fasta(recs):
    return "".join(f">{r.id}\n{r.seq}\n" for r in recs)


def _run_engine(data_dir, recs, aa, **kw):
    out = io.StringIO()
    Engine(EngineConfig(aa=aa, min_hits=2, device="cpu", **kw)).run(
        data_dir, None, out, stdout=True,
        query_stream=io.StringIO(_fasta(recs)))
    return out.getvalue()


def _record_blocks(report: str, aa: bool):
    """Split a report into per-record blocks keyed by record id."""
    head = "PROTEIN-ID\t" if aa else "processing "
    blocks = {}
    cur_id, cur = None, []
    for line in report.splitlines():
        if line.startswith(head):
            if cur_id is not None:
                blocks[cur_id] = "\n".join(cur)
            cur_id = re.split(r"[\t\[]", line[len(head):])[0]
            cur = [line]
        elif cur_id is not None:
            cur.append(line)
    if cur_id is not None:
        blocks[cur_id] = "\n".join(cur)
    return blocks


def _corpus(tmp_path, seed, n):
    rng = random.Random(seed)
    prots = ["".join(rng.choice(AA) for _ in range(rng.randint(15, 80)))
             for _ in range(n)]
    d = str(tmp_path / "d")
    write_data_dir(d, signatures_from_proteins(
        [(p, i % 6, i % 4) for i, p in enumerate(prots)]),
        [f"f{i}" for i in range(6)])
    return d, prots


def test_round_robin_hosts_match_single_host(tmp_path):
    d, prots = _corpus(tmp_path, 13, 40)
    records = [FastaRecord(f"p{i}", p, "") for i, p in enumerate(prots)]
    single = _record_blocks(_run_engine(d, records, True), aa=True)
    merged = {}
    for host in range(3):
        shard = list(shard_records(records, host, 3))
        assert all(int(r.id[1:]) % 3 == host for r in shard)
        assert shard == list(jax_multihost.shard_records(records, host, 3))
        merged.update(_record_blocks(_run_engine(d, shard, True), aa=True))
    assert merged == single
    assert len(single) == len(prots)


@pytest.mark.parametrize("grouping", ["host", "scan"])
@pytest.mark.parametrize("aa", [True, False])
def test_merge_report_shards_byte_identical(tmp_path, aa, grouping):
    """merge_report_shards reassembles per-host report shards into the
    exact single-run bytes, which are the JAX engine's, in aa and DNA mode
    (ref KmerGutsJava.java:398-404, :516-522; ordering :805-818)."""
    d, prots = _corpus(tmp_path, 29, 25)
    if aa:
        records = [FastaRecord(f"p{i}", p, "") for i, p in enumerate(prots)]
    else:
        records = [FastaRecord(f"c{i}", "".join(CODON[c] for c in p), "")
                   for i, p in enumerate(prots)]
    single = _run_engine(d, records, aa, grouping_impl=grouping)
    want = io.StringIO()
    JaxEngine(JaxConfig(aa=aa, min_hits=2)).run(
        d, None, want, stdout=True, query_stream=io.StringIO(_fasta(records)))
    assert single == want.getvalue()
    for nproc in (2, 3, 5):
        shards = [_run_engine(d, list(shard_records(records, p, nproc)), aa,
                              grouping_impl=grouping) for p in range(nproc)]
        assert merge_report_shards(shards) == single, (aa, nproc)
        assert jax_multihost.merge_report_shards(shards) == single
    blocks = split_report_blocks(single)
    assert len(blocks) == len(prots)
    assert all(b.startswith("PROTEIN-ID\t" if aa else "processing ")
               for b in blocks)
    assert "".join(blocks) == single
    assert blocks == jax_multihost.split_report_blocks(single)


def test_merge_report_shards_rejects_bad_input():
    with pytest.raises(ValueError, match="before the first record block"):
        split_report_blocks("Lookup time: 3 ms.\nPROTEIN-ID\tA\t20\n")
    # a non-round-robin partition (shard sizes impossible for one corpus)
    ok = "PROTEIN-ID\tA\t20\n"
    with pytest.raises(ValueError, match="round-robin"):
        merge_report_shards([ok, ok * 3])


def test_initialize_distributed_single_process_is_a_no_op():
    import torch.distributed as dist

    for n in (None, 0, 1):
        initialize_distributed("127.0.0.1:1", n, 0)
    assert not dist.is_initialized()


@pytest.mark.parametrize("kw, match", [
    (dict(backend=None), "name one of"),
    (dict(backend="mpi"), "name one of"),
    (dict(backend="gloo", process_id=None), "rank"),
    (dict(backend="gloo", process_id=2), "not in"),
    (dict(backend="gloo", coordinator_address=None), "address")])
def test_initialize_distributed_refuses_a_partial_setup(kw, match):
    """Nothing picks a backend or a rank silently; the refusal comes before
    any process group."""
    import torch.distributed as dist

    args = dict(coordinator_address="127.0.0.1:1", num_processes=2,
                process_id=0)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        initialize_distributed(**args)
    assert not dist.is_initialized()
