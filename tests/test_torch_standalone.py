"""The port stands alone: a copy of kmergutsjava_tpu_torch/ (without its
build/), with no JAX package beside it, builds its host C++ from its own
native/ into its own build directory and gives the goldens through its CLI
on the CPU without importing jax or the JAX package; a copy whose host C++
is missing or does not compile raises NativeBuildError instead of running
on the numpy twins; a read-only copy builds into the per-user cache; and
the twins still run where there is no g++ or a ``KMER_NO_NATIVE_*`` switch
is set; ``stale`` passes over a source that does not exist.

Every check runs the copy in a subprocess whose working directory and
PYTHONPATH are the copy's parent directory and nothing of the repository.
This process imports the JAX package only to build the corpus data dir."""
import gzip
import json
import os
import shutil
import subprocess
import sys

import pytest

from corpus_util import build_corpus_data_dir, corpus_path, load_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "kmergutsjava_tpu_torch"
LIBS = ("feeder", "scatter", "grouping", "fasta")
# printed by every check, after its own work: the modules of jax or of the
# JAX package that the process imported, and where the port came from
_TAIL = """
import kmergutsjava_tpu_torch
print("MODULES " + json.dumps([
    sorted(m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "kmergutsjava_tpu")),
    kmergutsjava_tpu_torch.__file__]))
"""


def copy_port(root, *ignore):
    """The port's package copied into ``root`` without build/ (and without
    files matching ``ignore``); returns ``root``."""
    os.makedirs(root, exist_ok=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("build", "__pycache__",
                                                  *ignore))
    return root


def run_copy(root, code, env=None, timeout=300):
    """``code`` (then _TAIL) run in a fresh interpreter on the copy in
    ``root``: (the process's result, its last MODULES line's value)."""
    base = {k: v for k, v in os.environ.items()
            if k != "PYTHONPATH" and not k.startswith("KMER_NO_NATIVE")}
    res = subprocess.run(
        [sys.executable, "-c", "import json, sys\n" + code + _TAIL],
        cwd=root, env={**base, "PYTHONPATH": root, **(env or {})},
        capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr
    line = [x for x in res.stdout.splitlines() if x.startswith("MODULES ")]
    bad, origin = json.loads(line[-1][len("MODULES "):])
    assert bad == []
    assert origin == os.path.join(root, PKG, "__init__.py")
    return res, origin


def _load(name):
    return f"""
from kmergutsjava_tpu_torch.utils import native
lib = native.load_{name}()
print("LOADED " + json.dumps([lib._name if lib is not None else None,
                              native.status()["{name}"], native.BUILD_DIR]))
"""


def _loaded(res):
    line = [x for x in res.stdout.splitlines() if x.startswith("LOADED ")]
    return json.loads(line[-1][len("LOADED "):])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """A copy of the port alone, and the 800-protein corpus data dir with
    its protein and contig queries and their goldens."""
    root = copy_port(str(tmp_path_factory.mktemp("port_alone")))
    assert sorted(os.listdir(root)) == [PKG]
    data = str(tmp_path_factory.mktemp("port_alone_data"))
    prots, _ = load_corpus(800, None)
    build_corpus_data_dir(os.path.join(data, "d"), prots)
    with open(os.path.join(data, "query.faa"), "w") as fh:
        fh.write("".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots))
    _, contig = load_corpus(0, 300_000)
    with open(os.path.join(data, "contig.fna"), "w") as fh:
        fh.write(f">{contig.id} {contig.descr}\n{contig.seq}\n")
    return root, data


@pytest.mark.parametrize("name", LIBS)
def test_each_loader_builds_from_the_copy(port, name):
    root, _ = port
    res, _ = run_copy(root, _load(name))
    path, status, build_dir = _loaded(res)
    assert build_dir == os.path.join(root, PKG, "build")
    assert path == os.path.join(build_dir, f"{name}.so")
    assert status == {"loaded": True,
                      "source": os.path.join(root, PKG, "native",
                                             f"{name}.cpp"),
                      "so": path, "why_not": None}


@pytest.mark.parametrize("aa,query,golden", [
    (True, "query.faa", "golden_aa_800.txt.gz"),
    (False, "contig.fna", "golden_dna_800.txt.gz")])
def test_copy_cli_gives_the_golden(port, aa, query, golden):
    root, data = port
    out = os.path.join(data, f"{query}.report")
    argv = [*(["-a"] if aa else []), "-D", os.path.join(data, "d"), "-q",
            os.path.join(data, query), "-o", out, "--device", "cpu"]
    res, _ = run_copy(root, f"""
from kmergutsjava_tpu_torch import cli
from kmergutsjava_tpu_torch.utils import native
assert cli.main({argv!r}) == 0
print("LOADED " + json.dumps([[n, getattr(lib, "_name", repr(lib))]
                              for n, lib in sorted(native._libs.items())]))
""")
    used = dict(_loaded(res))
    assert set(used) == set(LIBS)  # the host path is the native one
    for name, path in used.items():
        assert path == os.path.join(root, PKG, "build", f"{name}.so")
    with gzip.open(corpus_path(golden), "rt") as fh, open(out) as got:
        assert got.read() == fh.read()


@pytest.mark.parametrize("fault", ["missing", "uncompilable"])
def test_broken_native_source_raises(tmp_path, fault):
    """No numpy twin behind a copy that cannot build its host code: the
    loader raises NativeBuildError (the compiler's message with it), every
    time it is called, and status() says why."""
    if fault == "uncompilable" and shutil.which("g++") is None:
        pytest.skip("needs g++ to refuse a source")
    root = copy_port(str(tmp_path), *(["*.cpp"] if fault == "missing"
                                      else []))
    feeder = os.path.join(root, PKG, "native", "feeder.cpp")
    if fault == "uncompilable":
        with open(feeder, "a") as fh:
            fh.write("\nthis is not C++;\n")
    res, _ = run_copy(root, """
from kmergutsjava_tpu_torch.utils import native
for _ in range(2):
    try:
        native.load_feeder()
    except native.NativeBuildError as ex:
        assert isinstance(ex, RuntimeError)
        print("RAISED " + json.dumps(str(ex)))
    else:
        print("RETURNED")
print("LOADED " + json.dumps(native.status()["feeder"]))
""")
    raised = [json.loads(x[len("RAISED "):]) for x in res.stdout.splitlines()
              if x.startswith("RAISED ")]
    assert "RETURNED" not in res.stdout and len(raised) == 2
    if fault == "missing":
        assert raised[0] == f"missing native source {feeder}"
    else:
        assert raised[0].startswith(f"g++ failed on {feeder}:")
        assert "this is not C++" in raised[0]  # the compiler's stderr
    status = _loaded(res)
    assert not status["loaded"] and status["why_not"] == raised[0]


def test_read_only_copy_builds_into_the_user_cache(tmp_path):
    root = copy_port(str(tmp_path / "ro"))
    home = str(tmp_path / "home")
    pkg = os.path.join(root, PKG)
    os.chmod(pkg, 0o555)
    try:
        res, _ = run_copy(root, _load("feeder") + """
from kmergutsjava_tpu_torch.lookup import tilejoin
outs = []
native.compile_to = lambda cmd, out: outs.append(out)  # no nvcc here
try:
    tilejoin.build_cuda_library(tilejoin.SOURCE)
except tilejoin.KernelError:
    pass
print("KERNEL_OUT " + outs[0])
""", env={"HOME": home})
    finally:
        os.chmod(pkg, 0o755)
    path, status, build_dir = _loaded(res)
    assert build_dir == os.path.join(home, ".cache", PKG)
    # the CUDA kernels resolve the same directory
    assert f"KERNEL_OUT {build_dir}/libtilejoin.so" in res.stdout
    assert path == os.path.join(build_dir, "feeder.so") == status["so"]
    assert status["loaded"] and os.path.exists(path)
    assert not os.path.exists(os.path.join(pkg, "build"))


@pytest.mark.parametrize("why", ["switch", "no_gxx"])
def test_twin_taken_only_without_gxx_or_by_switch(tmp_path, why):
    """A fresh copy (nothing built) with no g++ on PATH, or with
    KMER_NO_NATIVE_FEEDER set, returns None and says why."""
    root = copy_port(str(tmp_path))
    env = ({"KMER_NO_NATIVE_FEEDER": "1"} if why == "switch"
           else {"PATH": str(tmp_path / "no_tools")})
    res, _ = run_copy(root, _load("feeder"), env=env)
    path, status, _ = _loaded(res)
    assert path is None and not status["loaded"]
    assert status["why_not"] == ("KMER_NO_NATIVE_FEEDER is set"
                                 if why == "switch" else "no g++ on PATH")


def test_stale_takes_missing_sources(tmp_path):
    """A library is stale when missing or older than a source that exists;
    a source that does not exist is passed over, never an error."""
    from kmergutsjava_tpu_torch.utils import native

    so, src = tmp_path / "lib.so", tmp_path / "a.cpp"
    gone = str(tmp_path / "gone.cpp")
    assert native.stale(str(so), [gone])
    so.write_text("")
    src.write_text("")
    os.utime(src, (100, 100))
    os.utime(so, (200, 200))
    assert not native.stale(str(so), [gone])
    assert not native.stale(str(so), [str(src), gone])
    os.utime(src, (300, 300))
    assert native.stale(str(so), [gone, str(src)])
