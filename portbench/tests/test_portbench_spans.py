"""The per-layer metrics that read the port's span log: a tiny read-set
run on the CPU twins reads each of them as a number, and a window that
holds no job reads none of them."""
import pytest

from portbench.core.harness import execute

from .conftest import tiny_run

METRICS = ["stream.scatter_ms.readset", "prepare.feed_wait_ms.readset",
           "stream.upload_ms.readset", "stream.readback_ms.readset",
           "stream.decode_ms.readset", "engine.worker_wait_ms.readset",
           "engine.unspanned_ms.readset"]
CELL = "dna-readsets-batch"


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """A traced run whose read sets are dense enough for the tiny table
    that ``auto`` streams them, as at the cell's size."""
    cell, run = tiny_run(CELL, tmp_path_factory.mktemp("spans"))
    run.workload["traffic"]["reads"] = 1500
    run.trace = True
    _, correct, metrics = execute(run, cell)
    assert correct
    return cell, run, metrics


@pytest.mark.parametrize("name", METRICS)
def test_traced_run_reads_the_span_metric(traced_run, name):
    cell, run, metrics = traced_run
    assert name in {m["name"] for m in cell["per_layer"]}
    value = metrics[name]["value"]
    assert isinstance(value, float) and value >= 0
    assert metrics[name]["unit"] == "ms"


@pytest.mark.parametrize("name", METRICS)
def test_window_without_jobs_reads_none(traced_run, name):
    cell, run, _ = traced_run
    saved = run.window
    try:
        run.window = (saved[0] - 3600.0, saved[0] - 1800.0)
        assert cell["readers"][name].read(run) is None
    finally:
        run.window = saved
