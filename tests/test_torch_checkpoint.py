"""The port's checkpoint/resume (kmergutsjava_tpu_torch/models/checkpoint.py)
and its CLI flags on the CPU, through the cases of tests/test_checkpoint.py,
each held against the JAX package's run_with_checkpoint on the same input
and batch size: the output bytes and the sidecar JSON must be equal. A run
started by one package and crashed resumes in the other to the single
run's bytes. A KernelError in a batch propagates (no exit 3, no ``Error:``
line) with the sidecar at its last commit, and a rerun resumes."""
import io
import json
import os

import pytest

from kmergutsjava_tpu.config import EngineConfig as JaxConfig
from kmergutsjava_tpu.models import checkpoint as jax_ckpt
from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine
from kmergutsjava_tpu_torch import cli
from kmergutsjava_tpu_torch.config import EngineConfig
from kmergutsjava_tpu_torch.formats.table_tools import (signatures_from_proteins,
                                                        write_data_dir)
from kmergutsjava_tpu_torch.lookup import sparse, tilejoin
from kmergutsjava_tpu_torch.models import checkpoint as ck_mod
from kmergutsjava_tpu_torch.models.checkpoint import (CheckpointError,
                                                      iter_groups,
                                                      run_with_checkpoint)
from kmergutsjava_tpu_torch.models.pipeline import Engine

AA = "ACDEFGHIKLMNPQRSTVWY"


class Boom(RuntimeError):
    pass


def _mk_corpus(n=23, seed=7):
    import random

    rng = random.Random(seed)
    lines = []
    for i in range(n):
        seq = "".join(rng.choice(AA) for _ in range(rng.randint(9, 60)))
        if rng.random() < 0.3:
            seq = AA + seq  # guaranteed hits for some records
        lines.append(f">P{i} some descr {i}\n{seq}\n")
        if rng.random() < 0.2:
            lines.append("\n")  # blank line noise (parser skips)
    return "".join(lines)


def _dna_corpus(n=12, seed=11):
    import random

    rng = random.Random(seed)
    return "".join(f">C{i}\n" + "".join(rng.choice("ACGT") for _ in range(
        rng.randint(60, 400))) + "\n" for i in range(n))


@pytest.fixture()
def data_dir(tmp_path):
    d = str(tmp_path / "d")
    write_data_dir(d, signatures_from_proteins(
        [(AA, 0, 3), (AA[::-1] + AA, 1, 5)], weight=0.5),
        ["funcA", "funcB"])
    return d


def _single_run(data_dir, fasta, aa=True, **kw):
    out = io.StringIO()
    Engine(EngineConfig(aa=aa, device="cpu", **kw)).run(
        data_dir, None, out, stdout=False, query_stream=io.StringIO(fasta))
    return out.getvalue()


def _port_cfg(**kw):
    return EngineConfig(**{"aa": True, "device": "cpu", **kw})


def _jax_cfg(**kw):
    return JaxConfig(**{"aa": True, **kw})


def _jax_run(tmp_path, data_dir, q, batch, name="jax", **kw):
    """The JAX package's checkpointed run: (output text, sidecar dict)."""
    out, ck = tmp_path / f"{name}.txt", tmp_path / f"{name}.ckpt"
    jax_ckpt.run_with_checkpoint(_jax_cfg(**kw), data_dir, str(q), str(out),
                                 str(ck), batch_groups=batch, progress=False)
    return out.read_text(), json.loads(ck.read_text())


def _crash_after(monkeypatch, engine_cls, n_ok):
    """Make ``engine_cls.run`` raise Boom on its call number n_ok + 1."""
    orig = engine_cls.run
    calls = {"n": 0}

    def crashing(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] > n_ok:
            raise Boom()
        return orig(self, *a, **kw)

    monkeypatch.setattr(engine_cls, "run", crashing)


def test_iter_groups_boundaries():
    text = "junk\n\n>A d\nSEQ\nSEQ2\n>\n>B\nQQQ\n  >C\nRRR\n"
    groups = list(iter_groups(io.StringIO(text)))
    assert ["".join(g) for g in groups] == [
        "junk\n\n>A d\nSEQ\nSEQ2\n", ">\n", ">B\nQQQ\n", "  >C\nRRR\n"]
    assert groups == list(jax_ckpt.iter_groups(io.StringIO(text)))


@pytest.mark.parametrize("mode,batch", [("aa", 5), ("aa", 1), ("dna", 5),
                                        ("dna", 4)])
def test_checkpoint_equals_single_run_and_jax(tmp_path, data_dir, mode,
                                              batch):
    aa = mode == "aa"
    fasta = _mk_corpus() if aa else _dna_corpus()
    n = 23 if aa else 12
    q = tmp_path / "q.fa"
    q.write_text(fasta)
    out, ck = tmp_path / "r.txt", tmp_path / "r.ckpt"
    assert run_with_checkpoint(_port_cfg(aa=aa), data_dir, str(q), str(out),
                               str(ck), batch_groups=batch,
                               progress=False) == n
    jax_text, jax_state = _jax_run(tmp_path, data_dir, q, batch, aa=aa)
    assert out.read_text() == _single_run(data_dir, fasta, aa=aa) == jax_text
    st = json.loads(ck.read_text())
    assert st == jax_state
    assert st["complete"] and st["groups_done"] == n
    # re-invoking a complete run is a no-op
    assert run_with_checkpoint(_port_cfg(aa=aa), data_dir, str(q), str(out),
                               str(ck), batch_groups=batch,
                               progress=False) == 0
    assert out.read_text() == jax_text


def test_crash_resume_with_torn_tail(tmp_path, data_dir, monkeypatch):
    fasta = _mk_corpus(n=17)
    q = tmp_path / "q.fa"
    q.write_text(fasta)
    out, ck = tmp_path / "r.txt", tmp_path / "r.ckpt"
    _crash_after(monkeypatch, Engine, 2)
    with pytest.raises(Boom):
        run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out), str(ck),
                            batch_groups=4, progress=False)
    monkeypatch.undo()
    st = json.loads(ck.read_text())
    assert st["groups_done"] == 8 and not st["complete"]
    with open(out, "ab") as fh:
        fh.write(b"TORN GARBAGE FROM THE CRASH")
    assert run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out),
                               str(ck), batch_groups=4,
                               progress=False) == 17 - 8
    jax_text, jax_state = _jax_run(tmp_path, data_dir, q, 4)
    assert out.read_text() == _single_run(data_dir, fasta) == jax_text
    assert json.loads(ck.read_text()) == jax_state


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages(tmp_path, data_dir, monkeypatch, first):
    """A run that one package committed two batches of and crashed (a torn
    tail after it) resumes in the other package to the single run's bytes;
    the sidecars the two write are the same JSON."""
    fasta = _mk_corpus(n=15, seed=3)
    q = tmp_path / "q.fa"
    q.write_text(fasta)
    out, ck = tmp_path / "r.txt", tmp_path / "r.ckpt"
    runs = {"jax": (jax_ckpt.run_with_checkpoint, _jax_cfg(), JaxEngine),
            "port": (run_with_checkpoint, _port_cfg(), Engine)}
    then = "port" if first == "jax" else "jax"
    start, cfg, engine_cls = runs[first]
    _crash_after(monkeypatch, engine_cls, 2)
    with pytest.raises(Boom):
        start(cfg, data_dir, str(q), str(out), str(ck), batch_groups=3,
              progress=False)
    monkeypatch.undo()
    crashed = json.loads(ck.read_text())
    assert crashed["groups_done"] == 6 and not crashed["complete"]
    with open(out, "ab") as fh:
        fh.write(b"TORN")
    finish, cfg, _ = runs[then]
    assert finish(cfg, data_dir, str(q), str(out), str(ck), batch_groups=3,
                  progress=False) == 15 - 6
    jax_text, jax_state = _jax_run(tmp_path, data_dir, q, 3)
    assert out.read_text() == _single_run(data_dir, fasta) == jax_text
    assert json.loads(ck.read_text()) == jax_state


def test_duplicate_ids_checkpointed_byte_identical(tmp_path, data_dir,
                                                   monkeypatch):
    """All occurrences of an id share a batch, at every batch size, so the
    single run's first-occurrence grouping holds (soak seed 253355989)."""
    fasta = (">A x\n" + AA + "\n>B y\n" + AA[::-1] + AA + "\n"
             ">A z\n" + AA + AA + "\n"
             ">C w\n" + AA + "\n>D v\n" + AA[5:] + AA + "\n")
    expect = _single_run(data_dir, fasta)
    ids = [line.split("\t")[1] for line in expect.splitlines()
           if line.startswith("PROTEIN-ID")]
    assert ids == ["A", "B", "C", "D"]
    q = tmp_path / "q.fa"
    q.write_text(fasta)
    for bg in (1, 2, 3, 10):
        out, ck = tmp_path / f"r{bg}.txt", tmp_path / f"r{bg}.ckpt"
        assert run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out),
                                   str(ck), batch_groups=bg,
                                   progress=False) == 5
        jax_text, jax_state = _jax_run(tmp_path, data_dir, q, bg,
                                       name=f"jax{bg}")
        assert out.read_text() == expect == jax_text
        assert json.loads(ck.read_text()) == jax_state
    # at batch_groups=1 the A..A span is one batch: commits at 3, 4, 5
    out, ck = tmp_path / "crash.txt", tmp_path / "crash.ckpt"
    _crash_after(monkeypatch, Engine, 1)
    with pytest.raises(Boom):
        run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out), str(ck),
                            batch_groups=1, progress=False)
    monkeypatch.undo()
    st = json.loads(ck.read_text())
    assert st["groups_done"] == 3 and not st["complete"]
    assert run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out),
                               str(ck), batch_groups=1, progress=False) == 2
    assert out.read_text() == expect


def test_prefix_digest_catches_inplace_edit_of_committed_region(
        tmp_path, data_dir, monkeypatch):
    monkeypatch.setattr(ck_mod, "_FULL_HASH_MAX", 0)  # force sampled mode
    fasta = _mk_corpus(n=9)
    q = tmp_path / "q.fa"
    q.write_text(fasta)
    out, ck = tmp_path / "r.txt", tmp_path / "r.ckpt"
    orig_run = Engine.run
    _crash_after(monkeypatch, Engine, 1)
    with pytest.raises(Boom):
        run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out), str(ck),
                            batch_groups=4, progress=False)
    monkeypatch.setattr(Engine, "run", orig_run)
    st = json.loads(ck.read_text())
    assert "sample_sha256" in st["input"] and st["groups_done"] == 4
    data = q.read_bytes()
    idx = data.index(b">P1") + 10
    q.write_bytes(data[:idx] + (b"W" if data[idx:idx + 1] != b"W"
                                else b"Y") + data[idx + 1:])
    monkeypatch.setattr(ck_mod, "_input_identity", lambda p: st["input"])
    with pytest.raises(CheckpointError, match="no longer match"):
        run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out), str(ck),
                            batch_groups=4, progress=False)


def test_mismatch_refusals(tmp_path, data_dir):
    fasta = _mk_corpus(n=6)
    q = tmp_path / "q.fa"
    q.write_text(fasta)
    out, ck = tmp_path / "r.txt", tmp_path / "r.ckpt"
    run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out), str(ck),
                        batch_groups=3, progress=False)
    with pytest.raises(CheckpointError, match="different parameters"):
        run_with_checkpoint(_port_cfg(min_hits=7), data_dir, str(q),
                            str(out), str(ck), progress=False)
    q.write_text(fasta + ">X\n" + AA + "\n")
    with pytest.raises(CheckpointError, match="different input"):
        run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out), str(ck),
                            progress=False)
    with pytest.raises(CheckpointError, match="non-debug"):
        run_with_checkpoint(_port_cfg(debug=True), data_dir, str(q),
                            str(out), str(ck), progress=False)
    with pytest.raises(CheckpointError, match=">= 1"):
        run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out), str(ck),
                            batch_groups=0, progress=False)
    q.write_text(fasta)
    os.unlink(out)
    with pytest.raises(CheckpointError, match="does not"):
        run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out), str(ck),
                            progress=False)
    # a sidecar of another version is refused
    st = json.loads(ck.read_text())
    ck.write_text(json.dumps({**st, "version": 1}))
    with pytest.raises(CheckpointError, match="version 1"):
        run_with_checkpoint(_port_cfg(), data_dir, str(q), str(out), str(ck),
                            progress=False)


def test_config_signature_equals_jax_and_ignores_backend_and_device(data_dir):
    sig = ck_mod._config_signature(_port_cfg(), data_dir)
    assert sig == jax_ckpt._config_signature(_jax_cfg(), data_dir)
    for other in (_port_cfg(backend="stream"), _port_cfg(device="cuda"),
                  _port_cfg(backend="pallas", lookup_chunk=4096)):
        assert ck_mod._config_signature(other, data_dir) == sig
    assert ck_mod._config_signature(_port_cfg(max_gap=7), data_dir) != sig


def test_backend_switch_on_resume_is_allowed(tmp_path, data_dir, monkeypatch):
    fasta = _mk_corpus(n=10)
    q = tmp_path / "q.fa"
    q.write_text(fasta)
    out, ck = tmp_path / "r.txt", tmp_path / "r.ckpt"
    _crash_after(monkeypatch, Engine, 1)
    with pytest.raises(Boom):
        run_with_checkpoint(_port_cfg(backend="xla"), data_dir, str(q),
                            str(out), str(ck), batch_groups=4,
                            progress=False)
    monkeypatch.undo()
    run_with_checkpoint(_port_cfg(backend="parity"), data_dir, str(q),
                        str(out), str(ck), batch_groups=4, progress=False)
    assert out.read_text() == _single_run(data_dir, fasta)


@pytest.mark.parametrize("fault", ["kernel", "device"])
def test_kernel_error_propagates_with_sidecar_at_last_commit(
        tmp_path, data_dir, monkeypatch, capsys, fault):
    """The third batch's probe fails: the CLI neither exits 3 nor prints an
    ``Error:`` line; the KernelError propagates, the sidecar holds the two
    committed batches, and a rerun resumes to the single run's bytes."""
    fasta = _mk_corpus(n=12, seed=5)
    q = tmp_path / "q.fa"
    q.write_text(fasta)
    out, ck = tmp_path / "r.txt", tmp_path / "r.ckpt"
    orig = sparse.tilejoin.probe_answer
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) > 2:
            if fault == "kernel":
                raise tilejoin.KernelError("launch refused")
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return orig(*a, **kw)

    monkeypatch.setattr(sparse.tilejoin, "probe_answer", failing)
    # --backend xla: these batches pass this small table's numSigs/2.5,
    # where auto would take the stream probe
    argv = ["-a", "-D", data_dir, "-q", str(q), "-o", str(out), "--device",
            "cpu", "--backend", "xla", "--checkpoint", str(ck),
            "--checkpoint-every", "4"]
    with pytest.raises(tilejoin.KernelError):
        cli.main(argv)
    assert "Error:" not in capsys.readouterr().out
    monkeypatch.undo()
    assert len(calls) == 3  # one dispatch a batch
    st = json.loads(ck.read_text())
    assert st["groups_done"] == 8 and not st["complete"]
    assert os.path.getsize(out) == st["out_offset"]
    assert cli.main(argv) == 0
    assert out.read_text() == _single_run(data_dir, fasta)
    assert json.loads(ck.read_text())["complete"]


def test_cli_checkpoint_flags(tmp_path, data_dir, capsys):
    from kmergutsjava_tpu import cli as jax_cli

    fasta = _mk_corpus(n=8)
    q = tmp_path / "q.fa"
    q.write_text(fasta)
    out, ck = tmp_path / "r.txt", tmp_path / "r.ckpt"
    assert cli.main(["-a", "-D", data_dir, "-q", str(q), "-o", str(out),
                     "--device", "cpu", "--checkpoint", str(ck),
                     "--checkpoint-every", "3"]) == 0
    assert "checkpoint: 8 groups committed" in capsys.readouterr().out
    assert json.loads(ck.read_text())["complete"]
    assert out.read_text() == _single_run(data_dir, fasta)
    capsys.readouterr()
    # the checks and their messages are the JAX CLI's, word for word
    for argv in (["-a", "-D", data_dir, "--checkpoint", str(ck)],
                 ["-a", "-D", data_dir, "-q", str(q), "-o", str(out),
                  "--checkpoint-every", "3"],
                 ["-a", "-d", "-D", data_dir, "-q", str(q), "-o", str(out),
                  "--checkpoint", str(ck)],
                 ["-a", "-D", data_dir, "-q", str(q), "-o", str(out),
                  "--checkpoint", str(ck), "--checkpoint-every", "0"]):
        assert cli.main(argv) == 2
        port_msg = capsys.readouterr().out.splitlines()[0]
        assert jax_cli.main(argv) == 2
        assert port_msg == capsys.readouterr().out.splitlines()[0]
        assert port_msg.startswith("Error: --checkpoint")
    assert "--checkpoint FILE" in cli.USAGE
    assert [line for line in cli.USAGE.splitlines() if "checkpoint" in line] \
        == [line for line in jax_cli.USAGE.splitlines()
            if "checkpoint" in line]
    # a refused resume exits 3 with the error on stderr
    q.write_text(fasta + ">X\n" + AA + "\n")
    assert cli.main(["-a", "-D", data_dir, "-q", str(q), "-o", str(out),
                     "--device", "cpu", "--checkpoint", str(ck)]) == 3
    assert "Error: checkpoint" in capsys.readouterr().err
