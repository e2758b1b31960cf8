"""A run driven without the look for a chip (the port on its CPU twins, at
a tiny size): sound, it comes out correct; with the timed path broken
underneath, or with the reference's bfloat16 control in the program's
place, it comes out not correct.

The faults a cell here can have: an answer altered where it is produced
(the lookup's hits), and half of the batch left out (half of a request's
or a job's records never reach the engine). The cells run one program on
one chip and keep no training state, so the faults of a step that returns
its state unchanged and of the exchange between chips do not apply."""
import io

import numpy as np
import pytest

from portbench.core.harness import execute
from portbench.core.judge import params
from portbench.reference import fasta
from portbench.reference.annotate import annotate

from .conftest import tiny_run

CELLS = ["dna-readsets-batch", "dna-genomes-served"]


def _query_text(query, query_stream):
    if query_stream is not None:
        return query_stream.read()
    with open(query, "rb") as fh:
        return fh.read().decode("latin-1")


def alter_answers(monkeypatch):
    """Every hit's weight one higher, as the lookup hands it on."""
    from kmergutsjava_tpu_torch.lookup import sparse, stream

    for cls in (sparse.StreamingLookup, stream.StreamingStreamLookup):
        orig = cls.finish

        def finish(self, *a, _orig=orig, **k):
            hits = _orig(self, *a, **k)
            hits.wt = np.asarray(hits.wt, np.float32) + np.float32(1)
            return hits

        monkeypatch.setattr(cls, "finish", finish)


def drop_half(monkeypatch):
    """Only the first half of the records reaches the engine."""
    from kmergutsjava_tpu_torch.models import pipeline

    orig = pipeline.Engine.run

    def run(self, data_dir, query, out_stream, stdout=False,
            query_stream=None):
        recs = list(fasta.parse(_query_text(query, query_stream)))
        half = "".join(f">{r.id}\n{r.seq}\n" for r in
                       recs[:max(1, len(recs) // 2)])
        return orig(self, data_dir, None, out_stream, stdout,
                    io.StringIO(half))

    monkeypatch.setattr(pipeline.Engine, "run", run)


def control_in_place(monkeypatch, config):
    """The reference in bfloat16 writes the report instead of the engine."""
    from kmergutsjava_tpu_torch.models import pipeline

    def run(self, data_dir, query, out_stream, stdout=False,
            query_stream=None):
        out_stream.write(annotate(_query_text(query, query_stream), data_dir,
                                  self.config.aa, params(config),
                                  precision="bfloat16"))

    monkeypatch.setattr(pipeline.Engine, "run", run)


@pytest.mark.parametrize("name", CELLS + ["aa-cold-cli"])
def test_sound_run_is_correct(name, tmp_path):
    cell, run = tiny_run(name, tmp_path)
    checks, correct, metrics = execute(run, cell)
    assert correct, checks
    assert {m["name"] for m in cell["end_to_end"]} == set(metrics)


@pytest.mark.parametrize("fault", [alter_answers, drop_half])
@pytest.mark.parametrize("name", CELLS)
def test_fault_comes_out_not_correct(name, fault, tmp_path, monkeypatch):
    cell, run = tiny_run(name, tmp_path)
    fault(monkeypatch)
    checks, correct, _ = execute(run, cell)
    assert not correct
    assert checks["differing_reports"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name, tmp_path, monkeypatch):
    """The control at a size a test holds: sums of fractional weights
    differ in bfloat16."""
    cell, run = tiny_run(name, tmp_path)
    control_in_place(monkeypatch, run.config)
    checks, correct, _ = execute(run, cell)
    assert not correct
    assert checks["differing_lines"]["value"] > 0
