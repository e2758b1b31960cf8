"""The port's JSON-RPC service (kmergutsjava_tpu_torch/service/) on the CPU,
against the JAX package's on the same data dir: the same result objects for
status, warm, annotate (aa and DNA, every backend the port has, inline and
by path) and the async protocol; the same HTTP codes, error codes and
messages for bad requests; each package's client against the other's
server. Then the cases of tests/test_service.py, test_service_ops.py,
test_async_job.py and test_api.py on the port: token auth and the access
log, /metrics, /healthz, /readyz, the body cap, job reaping, graceful
drain. Also: warm builds the lookup the first default annotate uses, a
KernelError reaches the client as error -32603 (sync and async) and never
as a report, and a ``cuda`` service on a machine without CUDA is not ready
and answers every annotate with an error."""
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from kmergutsjava_tpu.service import async_job as jax_async_job
from kmergutsjava_tpu.service import client as jax_client
from kmergutsjava_tpu.service.server import serve as jax_serve
import kmergutsjava_tpu_torch as kgt
from kmergutsjava_tpu_torch.formats.table_tools import (signatures_from_proteins,
                                                        write_data_dir)
from kmergutsjava_tpu_torch.lookup import sparse, tilejoin
from kmergutsjava_tpu_torch.models import pipeline
from kmergutsjava_tpu_torch.service import async_job
from kmergutsjava_tpu_torch.service.client import KmerGutsClient, ServerError
from kmergutsjava_tpu_torch.service.metrics import MetricsRegistry
from kmergutsjava_tpu_torch.service.server import KmerGutsService, serve

from corpus_util import build_corpus_data_dir, load_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AA = "ACDEFGHIKLMNPQRSTVWY"
BACKENDS = ["auto", "xla", "stream", "pallas", "parity", "spmd"]


@contextlib.contextmanager
def running(srv):
    """Serve ``srv`` on a thread; yields its URL; shuts it down after."""
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(30)


@contextlib.contextmanager
def both(data_dir, **kw):
    """A JAX server and a port server (device cpu) on ``data_dir``; yields
    their URLs."""
    with running(jax_serve(data_dir, port=0, **kw)) as jax_url, \
            running(serve(data_dir, port=0, device="cpu", **kw)) as port_url:
        yield jax_url, port_url


def post(url, body: bytes, headers=None):
    """One raw JSON-RPC POST: (HTTP code, decoded reply)."""
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as ex:
        return ex.code, json.load(ex)


def rpc(url, method, params, rpc_id="1"):
    return post(url, json.dumps({"version": "1.1", "method":
                                 f"KmerGutsJava.{method}", "params": params,
                                 "id": rpc_id}).encode())


def get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as ex:
        return ex.code, ex.read().decode()


def wait_job(url, job_id):
    for _ in range(1200):
        code, reply = rpc(url, "_check_job", [job_id])
        if reply.get("result") and reply["result"][0].get("finished"):
            return code, reply
        time.sleep(0.05)
    raise AssertionError(f"job {job_id} did not finish")


@pytest.fixture()
def small_dir(tmp_path):
    """The data dir of the JAX package's service tests: one protein."""
    d = str(tmp_path / "d")
    write_data_dir(d, signatures_from_proteins([(AA, 0, 3)], weight=0.5),
                   ["funcA"])
    return d


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 300-protein corpus table with 40 proteins (every eighth outside
    the table's) and a 30 kbp contig as queries: the proteins stay below
    numSigs/2.5 (sparse), the contig's 6 frames pass it (dense)."""
    prots, contig = load_corpus(320, 30_000)
    d = tmp_path_factory.mktemp("svc")
    build_corpus_data_dir(str(d), prots[:300])
    faa = "".join(f">{p.id} {p.descr}\n{p.seq}\n"
                  for p in prots[::8][:40])
    fna = f">{contig.id} {contig.descr}\n{contig.seq}\n"
    paths = {}
    for name, text in (("q.faa", faa), ("q.fna", fna)):
        paths[name] = str(d / name)
        with open(paths[name], "w") as fh:
            fh.write(text)
    return str(d), {"aa": faa, "dna": fna}, paths


def test_status_and_warm_equal_jax(corpus):
    d, _, _ = corpus
    with both(d) as (jax_url, port_url):
        for method in ("status", "warm"):
            assert rpc(port_url, method, []) == rpc(jax_url, method, [])
        code, reply = rpc(port_url, "warm", [])
        assert code == 200 and reply["result"][0]["probe_window"] >= 8


@pytest.mark.parametrize("mode", ["aa", "dna"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_annotate_equals_jax(corpus, mode, backend):
    """The same result object from both servers, inline and by path."""
    d, texts, paths = corpus
    opts = {"aa": mode == "aa", "backend": backend}
    if backend == "xla":  # the grouping parameters travel too
        opts.update(min_hits=3, max_gap=50, order_constraint=True,
                    min_weighted_hits=1)
    path = paths["q.faa" if mode == "aa" else "q.fna"]
    with both(d) as (jax_url, port_url):
        for params in ({"fasta": texts[mode], **opts},
                       {"fasta_path": path, **opts}):
            got = rpc(port_url, "annotate", [params])
            assert got == rpc(jax_url, "annotate", [params])
            assert got[0] == 200 and "CALL\t" in got[1]["result"][0]["report"]


def test_async_protocol_equals_jax(corpus):
    d, texts, paths = corpus
    with both(d) as (jax_url, port_url):
        for params in ({"fasta": texts["aa"], "aa": True},
                       {"fasta_path": paths["q.fna"]},
                       {}):  # an error delivered through _check_job
            replies = []
            for url in (jax_url, port_url):
                code, sub = rpc(url, "_annotate_submit", [params])
                assert code == 200
                replies.append((sub, wait_job(url, sub["result"][0])))
            assert replies[1] == replies[0]
        sync = rpc(port_url, "annotate", [{"fasta": texts["aa"],
                                           "aa": True}])[1]["result"]
        assert replies[1][1][1]["result"][0]["error"]["message"] == \
            "annotate needs 'fasta' or 'fasta_path'"
        code, reply = wait_job(port_url, "job_1")
        assert reply["result"][0]["result"] == sync


def test_errors_equal_jax(small_dir):
    """Same HTTP code and JSON reply from both servers for bad requests."""
    cases = [
        json.dumps({"method": "KmerGutsJava.nope", "params": [],
                    "id": "7", "version": "1.1"}).encode(),
        json.dumps({"method": "KmerGutsJava.annotate", "params": [{}],
                    "id": 8}).encode(),
        json.dumps({"method": "KmerGutsJava.annotate", "params": ["x"],
                    "id": 9}).encode(),
        json.dumps({"method": "KmerGutsJava.annotate", "params": [
            {"fasta": ">P\n" + AA + "\n", "min_hits": "many"}]}).encode(),
        json.dumps({"method": "KmerGutsJava._check_job",
                    "params": ["job_999999"], "id": 10}).encode(),
        json.dumps({"method": "KmerGutsJava._check_job",
                    "params": []}).encode(),
        json.dumps({"method": "KmerGutsJava.annotate", "params": [
            {"fasta": ">P\n" + "A" * 8192 + "\n", "aa": True}]}).encode(),
        b"{not json",
    ]
    with both(small_dir, max_body_bytes=4096) as (jax_url, port_url):
        for body in cases:
            got = post(port_url, body)
            assert got == post(jax_url, body)
            assert got[0] in (413, 500) and "error" in got[1]
        codes = [post(port_url, body)[1]["error"]["code"] for body in cases]
        assert codes == [-32601, -32000, -32000, -32603, -32000, -32000,
                         -32002, -32603]


def test_clients_cross_servers(corpus):
    """The wire format is shared: each package's client drives the other
    package's server to the same answers."""
    d, texts, _ = corpus
    with both(d) as (jax_url, port_url):
        for client in (jax_client.KmerGutsClient(port_url),
                       KmerGutsClient(jax_url)):
            assert client.status()["state"] == "OK"
            sync = client.annotate(fasta=texts["aa"], aa=True)
            assert "CALL\t" in sync
            assert client.annotate_async(fasta=texts["aa"], aa=True) == sync
            with pytest.raises(Exception, match="unknown job id"):
                client.check_job("job_999999")
        assert KmerGutsClient(port_url).annotate(fasta=texts["aa"], aa=True) \
            == jax_client.KmerGutsClient(jax_url).annotate(fasta=texts["aa"],
                                                          aa=True)


def test_warm_builds_the_lookup_a_default_annotate_uses(corpus, monkeypatch):
    """warm reads the table and builds the sparse lookup into the caches a
    default annotate reads: the annotate builds nothing again."""
    from kmergutsjava_tpu_torch.lookup.sparse import SparseLookup

    d, texts, _ = corpus
    pipeline._LOOKUP_CACHE.clear()
    pipeline._TABLE_CACHE.clear()
    built = []
    orig = SparseLookup.__init__

    def counted(self, *a, **kw):
        built.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(SparseLookup, "__init__", counted)
    with running(serve(d, port=0, device="cpu")) as url:
        client = KmerGutsClient(url)
        st = client.warm()
        (key, lk), = pipeline._LOOKUP_CACHE.items()
        (table,) = pipeline._TABLE_CACHE.values()
        assert isinstance(lk, SparseLookup) and st["probe_window"] == lk.w1
        assert lk._cols is not None  # the verification's table columns
        assert key[0] == "xla" and key[-1] == "cpu"
        assert st["num_sigs"] == table.num_sigs
        client.annotate(fasta=texts["aa"], aa=True)
        assert list(pipeline._LOOKUP_CACHE.items()) == [(key, lk)]
        assert list(pipeline._TABLE_CACHE.values()) == [table]
        assert pipeline._LOOKUP_CACHE[key] is lk
    assert len(built) == 1


@pytest.mark.parametrize("fault", ["kernel", "device"])
def test_kernel_error_reaches_the_client_as_an_error(corpus, monkeypatch,
                                                     fault):
    """A KernelError (or a device fault surfacing as a torch RuntimeError,
    which the lookup turns into one) is code -32603, sync and async, and
    no report."""
    def broken(*a, **kw):
        if fault == "kernel":
            raise tilejoin.KernelError("launch refused")
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(sparse.tilejoin, "probe_answer", broken)
    d, texts, _ = corpus
    with running(serve(d, port=0, device="cpu")) as url:
        code, reply = rpc(url, "annotate", [{"fasta": texts["aa"],
                                              "aa": True}])
        assert code == 500 and "result" not in reply
        err = reply["error"]
        assert err["code"] == -32603
        assert err["message"].startswith("KernelError: ")
        assert ("launch refused" if fault == "kernel" else
                "dispatch failed") in err["message"]
        _, sub = rpc(url, "_annotate_submit", [{"fasta": texts["aa"],
                                                "aa": True}])
        _, job = wait_job(url, sub["result"][0])
        job = job["result"][0]
        assert "result" not in job and job["error"]["code"] == -32603
        # the async worker's message is str(ex), as in the JAX server
        assert err["message"] == "KernelError: " + job["error"]["message"]
        _, text = get(url + "/metrics")
        assert ('rpc_requests_total{method="annotate",'
                'outcome="internal_error"} 1') in text


def test_cuda_service_without_cuda_is_not_ready(small_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with running(serve(small_dir, port=0)) as url:  # device cuda
        code, body = get(url + "/readyz")
        assert code == 503 and "torch.cuda.is_available" in body
        assert get(url + "/healthz") == (200, "ok\n")
        for method, params in (("warm", []), ("annotate", [
                {"fasta": ">P1\n" + AA + "\n", "aa": True}])):
            code, reply = rpc(url, method, params)
            assert code == 500 and "result" not in reply
            assert reply["error"]["code"] == -32603
            assert "torch.cuda.is_available() is false" in \
                reply["error"]["message"]
    with running(serve(small_dir, port=0, device="cpu")) as url:
        assert get(url + "/readyz") == (200, "ok\n")
    with pytest.raises(ValueError, match="unknown device"):
        KmerGutsService(small_dir, device="tpu")


# --- the JAX package's service cases, on the port --------------------------

@pytest.fixture()
def server(small_dir):
    srv = serve(small_dir, port=0, device="cpu", max_body_bytes=4096)
    with running(srv) as url:
        yield srv, url


def test_status_and_roundtrip(server):
    _, url = server
    client = KmerGutsClient(url)
    st = client.status()
    assert st["state"] == "OK" and st["version"] == kgt.__version__
    report = client.annotate(fasta=">P1\n" + AA + "\n", aa=True, min_hits=5)
    assert "PROTEIN-ID\tP1\t20" in report
    assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000" in report
    with pytest.raises(ServerError, match="not a valid method"):
        client._call("nope", [])
    with pytest.raises(ServerError, match="fasta"):
        client._call("annotate", [{}])


def test_concurrent_annotate_requests(server):
    import concurrent.futures

    _, url = server
    client = KmerGutsClient(url)

    def call(i):
        return client.annotate(fasta=f">P{i}\n{AA}\n", aa=True)

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(call, range(8)))
    for i, rep in enumerate(results):
        assert f"PROTEIN-ID\tP{i}\t20" in rep
        assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000" in rep


def test_async_job_roundtrip_and_error(server):
    _, url = server
    client = KmerGutsClient(url)
    sync = client.annotate(fasta=">P1\n" + AA + "\n", aa=True)
    job_id = client.annotate_submit(fasta=">P1\n" + AA + "\n", aa=True)
    assert job_id.startswith("job_")
    assert wait_job(url, job_id)[1]["result"][0]["result"][0]["report"] \
        == sync
    assert client.annotate_async(fasta=">P1\n" + AA + "\n", aa=True) == sync
    jid = client._call("_annotate_submit", [{}])[0]
    assert "fasta" in wait_job(url, jid)[1]["result"][0]["error"]["message"]
    with pytest.raises(ServerError, match="unknown job id"):
        client.check_job("job_999999")


def test_metrics_exposition_and_outcomes(server):
    _, url = server
    client = KmerGutsClient(url)
    client.status()
    client.annotate(fasta=">P1\n" + AA + "\n", aa=True)
    for m in ('evil"method', 'x\nfake_metric 99', 'a\\b', 'plainbogus'):
        with pytest.raises(ServerError, match="not a valid method"):
            client._call(m, [])
    with pytest.raises(ServerError):
        client._call("annotate", [{}])
    code, text = get(url + "/metrics")
    assert code == 200
    assert '# TYPE rpc_requests_total counter' in text
    assert 'rpc_requests_total{method="status",outcome="ok"} 1' in text
    assert 'rpc_requests_total{method="annotate",outcome="ok"} 1' in text
    assert 'rpc_requests_total{method="annotate",outcome="rpc_error"} 1' \
        in text
    assert 'method="_unknown",outcome="no_such_method"} 4' in text
    assert 'annotate_input_bytes_total' in text
    assert 'rpc_request_seconds_bucket{le="+Inf",method="annotate"} 2' in text
    assert 'rpc_request_seconds_count{method="annotate"} 2' in text
    assert 'process_start_time_seconds' in text
    assert 'rpc_requests_in_flight 0' in text
    assert "evil" not in text and "fake_metric" not in text
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name = line.split("{", 1)[0].split(" ", 1)[0]
            assert name.replace("_", "").isalnum(), line


def test_metrics_registry_rendering():
    m = MetricsRegistry()
    m.inc("c_total", {"k": 'a"b\\c\nd'})
    assert 'c_total{k="a\\"b\\\\c\\nd"} 1' in m.render()
    for v in (0.001, 0.05, 0.3, 100.0):
        m.observe("rpc_request_seconds", v, {"method": "x"})
    text = m.render()
    for le, n in (("0.005", 1), ("0.1", 2), ("0.5", 3), ("300.0", 4),
                  ("+Inf", 4)):
        assert f'rpc_request_seconds_bucket{{le="{le}",method="x"}} {n}' \
            in text
    assert 'rpc_request_seconds_count{method="x"} 4' in text


def test_healthz_readyz_body_cap_and_404(server, tmp_path):
    _, url = server
    assert get(url + "/healthz") == (200, "ok\n")
    assert get(url + "/readyz") == (200, "ok\n")
    assert get(url + "/nope")[0] == 404
    code, reply = post(url, json.dumps({
        "method": "KmerGutsJava.annotate", "params": [
            {"fasta": ">P\n" + "A" * 8192 + "\n", "aa": True}],
        "id": 1, "version": "1.1"}).encode())
    assert code == 413 and reply["error"]["code"] == -32002
    assert 'outcome="body_too_large"} 1' in get(url + "/metrics")[1]
    # a data dir without a table file: not ready, still live
    with running(serve(str(tmp_path), port=0, device="cpu")) as bare:
        assert get(bare + "/readyz")[0] == 503
        assert get(bare + "/healthz")[0] == 200


def test_token_auth_and_access_log(small_dir, tmp_path):
    log = tmp_path / "access.log"
    with running(serve(small_dir, port=0, device="cpu", token="sekrit",
                       access_log=str(log))) as url:
        with pytest.raises(ServerError, match="Authorization required"):
            KmerGutsClient(url).status()
        assert KmerGutsClient(url, token="sekrit").status()["state"] == "OK"
        with pytest.raises(ServerError, match="Authorization required"):
            KmerGutsClient(url, token="wrong").status()
    lines = log.read_text().splitlines()
    assert len(lines) == 3
    assert '"POST / HTTP/1.1" 500 ' in lines[0]
    assert '"POST / HTTP/1.1" 200 ' in lines[1]


def test_auth_service_supersedes_token(small_dir):
    """--auth-url: tokens resolve through an auth endpoint (a local stub
    here), cached, as in the JAX server."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    from kmergutsjava_tpu_torch.service.auth import AuthClient

    seen = []

    class Auth(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            seen.append(body)
            ok = b"token=good" in body
            payload = json.dumps({"user_id": "alice"} if ok else
                                 {"error_msg": "bad token"}).encode()
            self.send_response(200 if ok else 401)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    auth_srv = HTTPServer(("127.0.0.1", 0), Auth)
    threading.Thread(target=auth_srv.serve_forever, daemon=True).start()
    try:
        auth = AuthClient(f"http://127.0.0.1:{auth_srv.server_address[1]}")
        with running(serve(small_dir, port=0, device="cpu", token="x",
                           auth=auth)) as url:
            assert KmerGutsClient(url, token="good").status()["state"] == "OK"
            assert KmerGutsClient(url, token="good").status()["state"] == "OK"
            with pytest.raises(ServerError, match="bad token"):
                KmerGutsClient(url, token="evil").status()
        assert len(seen) == 2  # the second good call hit the cache
    finally:
        auth_srv.shutdown()
        auth_srv.server_close()


def test_job_reaping_and_hard_cap():
    svc = KmerGutsService(None, device="cpu")
    now = time.time()
    with svc._jobs_lock:
        svc._jobs["job_old"] = {"finished": 1, "result": [1],
                                "_done_at": now - svc.JOB_TTL_S - 1}
        svc._jobs["job_new"] = {"finished": 1, "result": [1], "_done_at": now}
        svc._jobs["job_run"] = {"finished": 0}
        svc._reap_jobs(now)
        assert "job_old" not in svc._jobs
        assert "job_new" in svc._jobs and "job_run" in svc._jobs
    out = svc.check_job(["job_new"])[0]
    assert "_done_at" not in out and out["finished"] == 1
    svc = KmerGutsService(None, device="cpu")
    svc.MAX_JOBS = 5
    with svc._jobs_lock:
        for i in range(8):
            svc._jobs[f"job_{i}"] = {"finished": 1, "result": [],
                                     "_done_at": now + i}
        svc._jobs["job_r"] = {"finished": 0}
        svc._reap_jobs(now)
        assert len(svc._jobs) == 5
        assert "job_r" in svc._jobs and "job_7" in svc._jobs
        assert "job_0" not in svc._jobs


def test_graceful_drain(small_dir):
    srv = serve(small_dir, port=0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    client = KmerGutsClient(f"http://127.0.0.1:{srv.server_address[1]}")
    results = []
    rt = threading.Thread(target=lambda: results.append(
        client.annotate(fasta=">P1\n" + AA + "\n", aa=True)))
    rt.start()
    time.sleep(0.05)
    assert srv.drain(timeout_s=30.0)
    rt.join(30.0)
    t.join(30.0)
    assert not rt.is_alive() and not t.is_alive()
    assert results and "PROTEIN-ID\tP1\t20" in results[0]


def test_server_main_serves_and_drains_on_sigterm(small_dir):
    """The entry point a user starts: ``--device cpu --warm -p 0`` prints
    the warm line and the bound port, serves, and drains on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kmergutsjava_tpu_torch.service.server", "-D",
         small_dir, "-p", "0", "--device", "cpu", "--warm"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        warm = proc.stdout.readline()
        assert warm.startswith("warm: num_sigs="), proc.stderr.read()
        line = proc.stdout.readline()
        assert line.startswith("serving on :") and "device=cpu" in line
        url = f"http://127.0.0.1:{int(line.split(':')[1].split()[0])}"
        assert "funcA" in KmerGutsClient(url).annotate(
            fasta=">P1\n" + AA + "\n", aa=True)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "drained cleanly" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


# --- the async-job runner and the library surface ---------------------------

def test_async_job_runner_equals_jax(small_dir, tmp_path):
    req = {"version": "1.1", "id": "1", "method": "KmerGutsJava.annotate",
           "params": [{"fasta": ">P1\n" + AA + "\n", "aa": True}]}
    inp = tmp_path / "in.json"
    inp.write_text(json.dumps(req))
    jax_out, out = tmp_path / "jax.json", tmp_path / "out.json"
    assert jax_async_job.run_job(str(inp), str(jax_out), small_dir) == 0
    assert async_job.main([str(inp), str(out), "-D", small_dir, "--device",
                           "cpu"]) == 0
    assert json.loads(out.read_text()) == json.loads(jax_out.read_text())
    assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000" in \
        json.loads(out.read_text())["result"][0]["report"]
    # errors: an unknown method, and (without CUDA) a cuda job
    inp.write_text(json.dumps({"method": "KmerGutsJava.nope", "params": []}))
    assert async_job.run_job(str(inp), str(out), device="cpu") == 1
    assert json.loads(out.read_text())["error"]["code"] == -32601
    assert async_job.main([str(inp)]) == 2
    if not torch.cuda.is_available():
        inp.write_text(json.dumps(req))
        assert async_job.run_job(str(inp), str(out), small_dir) == 1
        err = json.loads(out.read_text())["error"]
        assert err["code"] == -32603 and "torch.cuda" in err["message"]


def test_library_surface():
    """test_api.py's cases on the port's lazy exports."""
    import io

    for name in kgt.__all__:
        assert getattr(kgt, name) is not None
    with pytest.raises(AttributeError):
        kgt.no_such_symbol
    recs = list(kgt.read_fasta(io.StringIO(">a b\nACDEF\n")))
    assert recs == [kgt.FastaRecord("a", "ACDEF", "b")]


def test_library_round_trip(tmp_path):
    import io

    sig = kgt.signatures_from_proteins([(AA, 0, 3)], weight=0.5)
    d = str(tmp_path / "data")
    kgt.write_data_dir(d, sig, ["funcA"])
    assert kgt.read_table(d + "/kmer.table.mem_map").num_sigs > 0
    assert kgt.load_function_index(d + "/function.index") == ["funcA"]
    out = io.StringIO()
    kgt.Engine(kgt.EngineConfig(aa=True, device="cpu")).run(
        d, None, out, stdout=True, query_stream=io.StringIO(f">P1\n{AA}\n"))
    text = out.getvalue()
    assert text.splitlines()[0] == "PROTEIN-ID\tP1\t20"
    assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000" in text
