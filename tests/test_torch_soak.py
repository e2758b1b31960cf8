"""Randomized differential of the port against the JAX package on the CPU:
each seed's round (tests/torch_soak_rounds.py: a random table and query
set, random grouping parameters, sometimes debug mode and ``-l`` spills)
runs every port run of the round (each backend, the mesh backends on
positions of the CPU, the grouping kernel's, the home-sorted and the device
prepare's runs, a checkpoint run), each of which must be byte-equal to the
JAX ``parity`` Engine (debug timing lines masked). A few seeds run in the
tier-1 suite; ``-m slow`` runs many more."""
import io

import pytest

from kmergutsjava_tpu.config import EngineConfig as JaxConfig
from kmergutsjava_tpu.models.pipeline import Engine as JaxEngine

from torch_soak_rounds import _strip, make_round, port_reports


def run_round(seed, tmp, monkeypatch):
    rng, d, fasta, kw = make_round(seed, tmp)
    out = io.StringIO()
    JaxEngine(JaxConfig(backend="parity", **kw)).run(
        d, None, out, stdout=True, query_stream=io.StringIO(fasta))
    base = _strip(out.getvalue())
    for label, got in port_reports(seed, tmp, rng, d, fasta, kw, "cpu",
                                   monkeypatch.setenv):
        assert got == base, (
            f"seed {seed}: {label} diverged from the JAX parity engine")


# between them: aa and DNA, spills, duplicate ids, debug, a gzipped table
@pytest.mark.parametrize("seed", [11, 12, 15, 18, 20, 24, 26, 28, 30])
def test_soak_round(seed, tmp_path, monkeypatch):
    run_round(seed, str(tmp_path), monkeypatch)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(1000, 1400))
def test_soak_round_many(seed, tmp_path, monkeypatch):
    run_round(seed, str(tmp_path), monkeypatch)
