"""Real multi-process runs of the port over ``torch.distributed``: two gloo
processes on the CPU, each holding two positions of a mesh that spans both
(the counterpart of tests/test_multiprocess.py, whose worker runs the JAX
package), and four of one position each. Each rank runs the sharded lookup
on a (2, 2) mesh, the routed lookup over 4 shards, the stream shards over
4, the routed lookup over 2 (a mesh that leaves some ranks without a
position) and the sharded sparse probe over 4 (one-shot, and streamed with
its chunks sorted on the device), each with the parity scan's hits; the
fused step (``spmd``) on a (2, 2) mesh over the processes, aa and DNA with
long records through windows, every rank consuming the whole corpus, its
hits equal to the single-process port's on a (2, 2) mesh of one process,
and the report made from them written out; checks that the replicated
lookup, which has no process-group form, refuses such a mesh; then runs the
engine on its round-robin share of a corpus. The parent merges the report
shards and holds them, and each rank's fused-step reports, to the JAX
engine's single runs, byte for byte.

The worker is this file's ``__main__`` block and imports only the port:

    python tests/test_torch_multiprocess.py HOST:PORT WORLD RANK BACKEND \\
        DEVICE WORKDIR

(BACKEND gloo or nccl; DEVICE cpu or cuda: with cuda each rank takes card
``rank % cards``, and NCCL needs one rank a card). It prints one ``MP-OK``
line a check, and exits non-zero on any failure. Every collective and the
process group's start have a timeout, and the parent waits for each rank
with one, so a hung rank fails the test instead of stalling the suite.
``tests/test_torch_kernels.py`` runs the same worker on four cards under
NCCL."""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)
MARKS = ("MP-OK sharded (2, 2)", "MP-OK routed 4", "MP-OK stream-shards 4",
         "MP-OK routed 2", "MP-OK tilejoin-shards 4",
         "MP-OK tilejoin-shards 4 streamed", "MP-OK spmd aa (2, 2)",
         "MP-OK spmd dna (2, 2)", "MP-OK refusals", "MP-OK engine-shard",
         "MP-WORKER-DONE")
# the fused step's records past these lengths go through windows (the
# engine's thresholds shrunk, as in tests/test_torch_spmd.py)
SHORT_LONG = dict(LONG_AA=100, WIN_AA=64, LONG_NT=300, WIN_NT=150)
AA = "ACDEFGHIKLMNPQRSTVWY"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_corpus(workdir: str) -> None:
    """The engine check's data dir and corpus (unique ids, 30 proteins),
    and the fused step's queries: the proteins and a long one built from
    them (``spmd.faa``), reads translated back from them and a long contig
    (``spmd.fna``)."""
    import numpy as np

    from kmergutsjava_tpu_torch.formats.table_tools import (
        signatures_from_proteins, write_data_dir)

    rng = np.random.default_rng(9)
    prots = ["".join(AA[i] for i in rng.integers(0, 20, int(n)))
             for n in rng.integers(12, 90, 30)]
    write_data_dir(os.path.join(workdir, "d"), signatures_from_proteins(
        [(p, i % 5, i % 7) for i, p in enumerate(prots)]),
        [f"fn{i}" for i in range(5)])
    with open(os.path.join(workdir, "corpus.faa"), "w") as fh:
        fh.write("".join(f">p{i}\n{p}\n" for i, p in enumerate(prots)))
    joined = "".join(prots)
    with open(os.path.join(workdir, "spmd.faa"), "w") as fh:
        fh.write("".join(f">p{i}\n{p}\n" for i, p in enumerate(prots))
                 + f">long\n{joined[:400]}\n")
    codon = {}
    for i, a in enumerate("KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGG"
                          "VVVV*Y*YSSSS*CWCLFLF"):
        codon.setdefault(a, "ACGT"[i // 16] + "ACGT"[i // 4 % 4]
                         + "ACGT"[i % 4])
    nt = "".join(codon[c] for c in joined)
    reads = [nt[a:a + 60] for a in rng.integers(0, len(nt) - 60, 24)]
    with open(os.path.join(workdir, "spmd.fna"), "w") as fh:
        fh.write("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads))
                 + f">ctg\n{nt[:1200]}\n")


def jax_report(workdir: str, query: str, aa: bool) -> str:
    """The JAX engine's single-run report of ``query`` against the data
    dir (min_hits 2)."""
    import io

    from kmergutsjava_tpu.config import EngineConfig as JaxConfig
    from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine

    out = io.StringIO()
    JaxEngine(JaxConfig(aa=aa, min_hits=2)).run(
        os.path.join(workdir, "d"), os.path.join(workdir, query), out,
        stdout=True)
    return out.getvalue()


def run_ranks(workdir: str, world: int, backend: str, device: str,
              timeout: float = 240.0):
    """Start ``world`` worker processes and wait for each (killed by their
    exact handles if one times out); returns [(returncode, output)]."""
    addr = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, addr, str(world), str(rank), backend,
         device, workdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def check_ranks(outs) -> None:
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
        for mark in MARKS:
            assert mark in out, f"rank {rank} missing {mark}:\n{out[-4000:]}"


@pytest.mark.parametrize("world", [2, 4])
def test_multi_process_gloo(tmp_path, world):
    """Two ranks of two positions (a data row of the (2, 2) mesh a rank:
    its sum stays in the process) or four of one (each row's sum an
    all_reduce over a two-rank group)."""
    import io

    from kmergutsjava_tpu.config import EngineConfig as JaxConfig
    from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine
    from kmergutsjava_tpu_torch.parallel.multihost import merge_report_shards

    write_corpus(str(tmp_path))
    outs = run_ranks(str(tmp_path), world, "gloo", "cpu")
    check_ranks(outs)
    assert all(f"positions={4 // world}" in out for _, out in outs)
    merged = merge_report_shards([(tmp_path / f"report_{r}.txt").read_text()
                                  for r in range(world)])
    single = io.StringIO()
    JaxEngine(JaxConfig(aa=True, min_hits=2)).run(
        str(tmp_path / "d"), str(tmp_path / "corpus.faa"), single,
        stdout=True)
    assert merged == single.getvalue(), \
        "merged multi-process report != the JAX engine's single run"
    assert merged.count("PROTEIN-ID") == 30 and "CALL\t" in merged
    check_spmd_reports(tmp_path, world, jax_report)


def check_spmd_reports(tmp_path, world, single) -> None:
    """Every rank's fused-step reports (aa, DNA) equal ``single``'s (the
    JAX engine's, or the port's on the card) byte for byte."""
    for mode, query in (("aa", "spmd.faa"), ("dna", "spmd.fna")):
        want = single(str(tmp_path), query, mode == "aa")
        assert "CALL\t" in want
        for r in range(world):
            got = (tmp_path / f"spmd_{mode}_{r}.txt").read_text()
            assert got == want, f"rank {r}: spmd {mode} report differs"


def worker(addr: str, world: int, rank: int, backend: str, device: str,
           workdir: str) -> None:
    """One rank: the three lookups over a mesh of 4 positions spanning the
    ranks, then the engine on this rank's share of the corpus."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from kmergutsjava_tpu_torch.config import EngineConfig
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta
    from kmergutsjava_tpu_torch.formats.kmer_table import build_table
    from kmergutsjava_tpu_torch.lookup.parity import lookup_stream
    from kmergutsjava_tpu_torch.models.pipeline import Engine
    from kmergutsjava_tpu_torch.parallel import (mesh, routed_lookup,
                                                 sharded_lookup,
                                                 stream_shards)
    from kmergutsjava_tpu_torch.parallel.multihost import (
        initialize_distributed, shard_records)

    if device == "cuda":
        card = rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        dev = f"cuda:{card}"
    else:
        dev = "cpu"
    initialize_distributed(addr, world, rank, backend=backend,
                           timeout_s=120)
    devs = [dev] * (4 // world)

    rng = np.random.default_rng(5)
    kmers = np.unique(rng.integers(0, 20**8, 5000, dtype=np.int64))
    table = build_table(
        kmers, rng.integers(0, 50, len(kmers)).astype(np.int32),
        rng.integers(0, 500, len(kmers)).astype(np.int32),
        rng.integers(0, 30, len(kmers)).astype(np.int32),
        rng.random(len(kmers)).astype(np.float32))
    table.compute_max_probe()
    values = np.concatenate([rng.choice(kmers, 3000),
                             rng.integers(0, 20**8, 3000, dtype=np.int64)])
    cnt = np.zeros(len(values), np.int64)
    pos = np.arange(len(values), dtype=np.int64)
    want = lookup_stream(table, values, cnt, pos)
    want = sorted(zip(want.pos.tolist(), want.otu.tolist(),
                      want.fi.tolist()))

    from kmergutsjava_tpu_torch.lookup import stream, tilejoin
    from kmergutsjava_tpu_torch.parallel import route_bins, shard_probe

    kernels = dict(B1=tilejoin, B2=stream, B12=shard_probe, B13=route_bins)

    def check(name, lk):
        before = {k: m.launches for k, m in kernels.items()}
        hits = lk.lookup(values, cnt, pos)
        got = sorted(zip(hits.pos.tolist(), hits.otu.tolist(),
                         hits.fi.tolist()))
        assert got == want, f"{name}: hit mismatch"
        launched = {k: m.launches - before[k] for k, m in kernels.items()}
        print(f"MP-OK {name} positions={len(lk.mesh.positions())} "
              f"hits={len(got)} launches={launched}", flush=True)

    check("sharded (2, 2)", sharded_lookup.ShardedLookup(
        table, mesh.make_mesh(2, 2, devs, distributed=True),
        max(8, table.max_probe)))
    check("routed 4", routed_lookup.RoutedLookup(
        table, mesh.make_mesh(1, 4, devs, distributed=True),
        probe_window=max(16, table.max_probe)))
    check("stream-shards 4", stream_shards.StreamShardedLookup(
        table, stream_shards.make_stream_mesh(4, devs, distributed=True)))
    # a mesh on the first ranks' devices only: the other ranks hold no
    # position and still take part in every collective
    check("routed 2", routed_lookup.RoutedLookup(
        table, mesh.make_mesh(1, 2, devs, distributed=True),
        probe_window=max(16, table.max_probe)))

    from kmergutsjava_tpu_torch.lookup.sparse import StreamingLookup
    from kmergutsjava_tpu_torch.parallel import (replicated_lookup,
                                                 tilejoin_shards)

    # a few dispatches a lookup: each resolve one gather a chunk
    tj = tilejoin_shards.TileJoinShardedLookup(
        table, mesh.make_mesh(1, 4, devs, distributed=True), chunk=1024)
    check("tilejoin-shards 4", tj)
    before = {k: m.launches for k, m in kernels.items()}
    feed = StreamingLookup(tj, sort_chunks=True, device_sort=True)
    for a in range(0, len(values), 700):  # the engine's streamed feed
        feed.add_batch(values[a:a + 700], cnt[a:a + 700], pos[a:a + 700])
    hits = feed.finish()
    got = sorted(zip(hits.pos.tolist(), hits.otu.tolist(),
                     hits.fi.tolist()))
    assert got == want, "tilejoin-shards 4 streamed: hit mismatch"
    print(f"MP-OK tilejoin-shards 4 streamed hits={len(got)} launches="
          f"{ {k: m.launches - before[k] for k, m in kernels.items()} }",
          flush=True)

    spmd_checks(workdir, world, rank, device, devs)

    # the replicated lookup has no process-group form (nor has the JAX
    # package's: its answer is a device_get of an array on every process's
    # devices) and refuses a mesh over processes
    try:
        replicated_lookup.ReplicatedLookup(
            table, mesh.make_mesh(4, 1, devs, distributed=True))
    except ValueError as ex:
        assert "one process" in str(ex), ex
    else:
        raise AssertionError("a mesh over processes was taken")
    print("MP-OK refusals", flush=True)

    import io

    records = list(read_fasta(os.path.join(workdir, "corpus.faa")))
    mine = list(shard_records(records, rank, world))
    out = io.StringIO()
    Engine(EngineConfig(aa=True, min_hits=2, device=device)).run(
        os.path.join(workdir, "d"), None, out, stdout=True,
        query_stream=io.StringIO("".join(f">{r.id}\n{r.seq}\n"
                                         for r in mine)))
    text = out.getvalue()
    assert text.count("PROTEIN-ID") == len(mine)
    with open(os.path.join(workdir, f"report_{rank}.txt"), "w") as fh:
        fh.write(text)
    print(f"MP-OK engine-shard n={len(mine)}", flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print("MP-WORKER-DONE", flush=True)


def spmd_checks(workdir: str, world: int, rank: int, device: str,
                devs) -> None:
    """The fused step on a (2, 2) mesh over the processes, aa and DNA (long
    records through windows, small batches so that several decodes are in
    flight): every rank consumes the whole corpus, its hits equal the
    single-process port's on a (2, 2) mesh of this process's device, and
    the report made from them is written to ``spmd_<mode>_<rank>.txt``."""
    import io

    import numpy as np

    from kmergutsjava_tpu_torch.calls.grouping import (
        GroupingParams, Report, process_aa_seq, process_dna_seq)
    from kmergutsjava_tpu_torch.config import EngineConfig
    from kmergutsjava_tpu_torch.formats.fasta import read_fasta
    from kmergutsjava_tpu_torch.formats.function_index import \
        load_function_index
    from kmergutsjava_tpu_torch.formats.kmer_table import (
        read_table, resolve_table_files)
    from kmergutsjava_tpu_torch.models import spmd
    from kmergutsjava_tpu_torch.models.pipeline import Engine
    from kmergutsjava_tpu_torch.parallel import fused_probe, mesh

    for name, value in SHORT_LONG.items():
        setattr(spmd, name, value)
    table_path, func_path = resolve_table_files(os.path.join(workdir, "d"))
    table = read_table(table_path)
    functions = load_function_index(func_path)
    for mode, query in (("aa", "spmd.faa"), ("dna", "spmd.fna")):
        aa = mode == "aa"
        cfg = EngineConfig(aa=aa, backend="spmd", device=device, min_hits=2)
        records = list(read_fasta(os.path.join(workdir, query)))

        def hits_of(program):
            ann = spmd.SpmdAnnotator(table, cfg, program=program,
                                     batch_rows=5)
            prep = ann.consume(records)
            return prep, ann.finish()

        before = fused_probe.launches
        prog = spmd.SpmdProgram(table, cfg, mesh=mesh.make_mesh(
            2, 2, devs, distributed=True))
        prep, hits = hits_of(prog)
        launched = fused_probe.launches - before
        one = spmd.SpmdProgram(table, EngineConfig(
            aa=aa, backend="spmd", device=device, mesh_shape=(2, 2),
            mesh_devices=[devs[0]] * 4))
        _, want = hits_of(one)
        for col in ("cnt_id", "pos", "otu", "avg_from_end", "fi", "wt"):
            np.testing.assert_array_equal(getattr(hits, col),
                                          getattr(want, col), err_msg=col)
        params = GroupingParams(min_hits=2,
                                min_weighted_hits=cfg.min_weighted_hits,
                                max_gap=cfg.max_gap,
                                order_constraint=cfg.order_constraint)
        by_container = Engine(cfg)._bucket_hits(prep, hits, functions,
                                                params)
        out = io.StringIO()
        report = Report(out)
        for qid, length in prep.id_len.items():
            (process_aa_seq if aa else process_dna_seq)(
                qid, length, by_container, functions, report, params)
        report.flush()
        with open(os.path.join(workdir, f"spmd_{mode}_{rank}.txt"),
                  "w") as fh:
            fh.write(out.getvalue())
        print(f"MP-OK spmd {mode} (2, 2) positions="
              f"{len(prog.mesh.positions())} hits={len(hits)} "
              f"launches={ {'fused_probe': launched} }", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           sys.argv[5], sys.argv[6])
