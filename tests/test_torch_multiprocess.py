"""Real multi-process runs of the port over ``torch.distributed``: two gloo
processes on the CPU, each holding two positions of a mesh that spans both
(the counterpart of tests/test_multiprocess.py, whose worker runs the JAX
package), and four of one position each. Each rank runs the sharded lookup
on a (2, 2) mesh, the routed lookup over 4 shards, the stream shards over
4 and the routed lookup over 2 (a mesh that leaves some ranks without a
position), each with the parity scan's hits; checks that the modes with no
process-group form refuse such a mesh; then runs the engine on its
round-robin share of a corpus, and the parent merges the report shards and
holds them to the JAX engine's single run, byte for byte.

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
         "MP-OK routed 2", "MP-OK refusals", "MP-OK engine-shard",
         "MP-WORKER-DONE")
AA = "ACDEFGHIKLMNPQRSTVWY"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_corpus(workdir: str) -> None:
    """The engine check's data dir and corpus (unique ids, 30 proteins)."""
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

    # the modes with no process-group form refuse a mesh over processes
    from kmergutsjava_tpu_torch.parallel import (annotate_step,
                                                 replicated_lookup,
                                                 tilejoin_shards)

    for build in (
            lambda: replicated_lookup.ReplicatedLookup(
                table, mesh.make_mesh(4, 1, devs, distributed=True)),
            lambda: tilejoin_shards.TileJoinShardedLookup(
                table, mesh.make_mesh(1, 4, devs, distributed=True)),
            lambda: annotate_step.sharded_planes(
                mesh.make_mesh(2, 2, devs, distributed=True), table, 16)):
        try:
            build()
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


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           sys.argv[5], sys.argv[6])
