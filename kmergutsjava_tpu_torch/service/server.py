"""JSON-RPC service front-end.

Re-creation of the reference's L3 layer (KmerGutsJavaServer.java — a KBase
JsonServerServlet whose only method is ``status()``, ref :33-45; the KIDL
spec is an empty module so the engine is unreachable over RPC). We keep the
same wire shape (JSON-RPC 1.1-style: {"method": "KmerGutsJava.<m>",
"params": [...], "id", "version"}) and expose:

- ``KmerGutsJava.status``  — same payload keys as the reference;
- ``KmerGutsJava.annotate`` — the engine itself (an extension the reference
  advertises in its docs but never wires up): params
  [{"fasta": text | "fasta_path": path, "aa": bool, "min_hits": int,
    "min_weighted_hits": int, "max_gap": int, "order_constraint": bool,
    "debug": bool, "backend": str}] -> [{"report": text}];
- ``KmerGutsJava._annotate_submit`` / ``KmerGutsJava._check_job`` — the
  async-job protocol the reference's generated clients speak
  (baseclient.py:_submit_job/_check_job; JS Client.js polls with backoff):
  submit returns a job id, _check_job([job_id]) returns
  [{"job_id", "finished": 0|1, "result"?|"error"?}].

Operational endpoints (GET; no reference counterpart — the reference's
only signal is Jetty's NCSA log): ``/metrics`` (Prometheus text,
service/metrics.py), ``/healthz`` (liveness), ``/readyz`` (readiness:
the service's torch device is usable and the data directory resolves to a
readable table). SIGTERM drains in-flight requests before exit
(``--drain-timeout``).

This is the JAX package's server (same wire shape, methods, metrics, auth,
body cap, drain and job reaping) on this package's Engine. The service
owns one torch device (``--device``, default ``cuda``) and never falls
back to the CPU: without CUDA a ``cuda`` service answers ``/readyz`` 503
and every annotate or warm returns an error. A KernelError reaches the
client as error -32603, never as a report.

Run: python -m kmergutsjava_tpu_torch.service.server -D <data_dir> [-p port]
     [--device cuda|cpu] [--warm]
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import __version__
from ..config import EngineConfig
from ..utils import timing
from .metrics import MetricsRegistry

GIT_URL = "https://github.com/kbaseapps/KmerGutsJava"


class RpcError(Exception):
    def __init__(self, message: str, code: int = -32000):
        super().__init__(message)
        self.code = code


class KmerGutsService:
    """Method registry; one instance owns one data directory."""

    # Finished jobs are kept for polling this long, then reaped; unfinished
    # jobs are never reaped. A hard cap bounds the table even under a
    # poll-never client flood (oldest finished go first).
    JOB_TTL_S = 3600.0
    MAX_JOBS = 10_000

    def __init__(self, data_dir: Optional[str] = None, device: str = "cuda"):
        EngineConfig(device=device)  # a bad device name fails here
        self.data_dir = data_dir
        self.device = device
        self._lock = threading.Lock()
        self._jobs: dict = {}          # job_id -> {"finished", "result"/"error"}
        self._jobs_lock = threading.Lock()
        self._job_seq = 0
        self.metrics = MetricsRegistry()
        m = self.metrics
        m.describe("rpc_requests_total", "counter",
                   "RPC requests by method and outcome")
        m.describe("rpc_request_seconds", "histogram",
                   "RPC request latency by method")
        m.describe("rpc_requests_in_flight", "gauge",
                   "RPC requests currently executing")
        m.describe("annotate_input_bytes_total", "counter",
                   "FASTA bytes received by annotate (inline uploads)")
        m.describe("async_jobs", "gauge",
                   "Async jobs tracked, by state")
        m.describe("engine_span_seconds", "histogram",
                   "Time an annotate request spent in each of the engine's "
                   "spans (its total over the request), by span")

    def ready(self):
        """Readiness: a status-only server (no -D) is ready; with a data
        dir, the service's device must be usable (a ``cuda`` service on a
        machine without CUDA would fail every annotate) and the table file
        must resolve and be readable."""
        if self.data_dir is None:
            return True, "ok (status-only: no data dir)"
        try:
            from ..formats.kmer_table import resolve_table_files
            from ..lookup.sparse import torch_device

            torch_device(self.device)  # raises where CUDA is missing
            table_path, _ = resolve_table_files(self.data_dir)
            with open(table_path, "rb"):
                pass
            return True, "ok"
        except Exception as ex:  # noqa: BLE001 — any failure = not ready
            return False, f"{type(ex).__name__}: {ex}"

    def _reap_jobs(self, now: Optional[float] = None) -> None:
        """Call with _jobs_lock held."""
        now = time.time() if now is None else now
        dead = [jid for jid, j in self._jobs.items()
                if j.get("finished") and now - j.get("_done_at", now)
                > self.JOB_TTL_S]
        for jid in dead:
            del self._jobs[jid]
        if len(self._jobs) > self.MAX_JOBS:
            finished = sorted(
                (j.get("_done_at", 0.0), jid)
                for jid, j in self._jobs.items() if j.get("finished"))
            for _, jid in finished[: len(self._jobs) - self.MAX_JOBS]:
                del self._jobs[jid]
        n_done = sum(1 for j in self._jobs.values() if j.get("finished"))
        self.metrics.set_gauge("async_jobs", n_done,
                               {"state": "finished"})
        self.metrics.set_gauge("async_jobs", len(self._jobs) - n_done,
                               {"state": "running"})

    def status(self, params):
        # Same keys as the reference servlet's status map (ref :35-44)
        return [{
            "state": "OK",
            "message": "",
            "version": __version__,
            "git_url": GIT_URL,
            "git_commit_hash": "",
        }]

    def _engine_config(self, p: dict) -> EngineConfig:
        """The engine config of one annotate request; ``warm`` builds it
        from no params, so its lookup's cache key equals a default
        annotate's (backend, probe window, chunk and device)."""
        return EngineConfig(
            aa=bool(p.get("aa", False)),
            min_hits=int(p.get("min_hits", 5)),
            min_weighted_hits=int(p.get("min_weighted_hits", 0)),
            max_gap=int(p.get("max_gap", 200)),
            order_constraint=bool(p.get("order_constraint", False)),
            debug=bool(p.get("debug", False)),
            backend=str(p.get("backend", "xla")),
            device=self.device,
        )

    def annotate(self, params):
        if self.data_dir is None:
            raise RpcError("server started without a data directory (-D)")
        if not params or not isinstance(params[0], dict):
            raise RpcError("annotate expects one object parameter")
        p = params[0]
        cfg = self._engine_config(p)
        from ..models.pipeline import Engine

        out = io.StringIO()
        if "fasta" in p:
            self.metrics.inc("annotate_input_bytes_total",
                             by=len(p["fasta"]))
        # device-resident table planes are per-call state, and each cached
        # lookup owns one CUDA stream: one request at a time on the engine
        asked = time.perf_counter_ns()
        with self._lock:
            with timing.record("service.annotate") as rec:
                rec.add("service.lock_wait", time.perf_counter_ns() - asked)
                if "fasta" in p:
                    Engine(cfg).run(self.data_dir, None, out, stdout=True,
                                    query_stream=io.StringIO(p["fasta"]))
                elif "fasta_path" in p:
                    Engine(cfg).run(self.data_dir, p["fasta_path"], out,
                                    stdout=True)
                else:
                    raise RpcError("annotate needs 'fasta' or 'fasta_path'")
        for name, got in rec.as_dict()["spans"].items():
            self.metrics.observe("engine_span_seconds", got["ns"] / 1e9,
                                 {"span": name})
        return [{"report": out.getvalue()}]

    def warm(self, params):
        """Preload what a default annotate request needs (the tile-join
        kernel's build, the host table, the sparse lookup's plane on the
        device and the table columns its host verification reads) into the
        caches that request reads, so it pays none of it."""
        if self.data_dir is None:
            raise RpcError("server started without a data directory (-D)")
        from ..formats.kmer_table import resolve_table_files
        from ..lookup import tilejoin
        from ..lookup.sparse import torch_device
        from ..models.pipeline import _cached_lookup, _cached_read_table

        cfg = self._engine_config({})
        table_path, _ = resolve_table_files(self.data_dir)
        with self._lock:
            if torch_device(cfg.device).type == "cuda":
                tilejoin.load_kernel()
            table = _cached_read_table(table_path)
            lk = _cached_lookup(cfg.backend, table_path, table, cfg)
            lk._table_cols()  # else the first request copies them
        return [{"num_sigs": table.num_sigs, "max_probe": table.max_probe,
                 "probe_window": lk.w1}]

    # -- async-job protocol (ref baseclient.py:_submit_job/_check_job) ------

    def _submit(self, target, params):
        with self._jobs_lock:
            self._reap_jobs()
            self._job_seq += 1
            job_id = f"job_{self._job_seq}"
            self._jobs[job_id] = {"finished": 0}

        def work():
            try:
                result = target(params)
                with self._jobs_lock:
                    self._jobs[job_id] = {"finished": 1, "result": result,
                                          "_done_at": time.time()}
            except Exception as ex:  # noqa: BLE001 — delivered via _check_job
                code = ex.code if isinstance(ex, RpcError) else -32603
                with self._jobs_lock:
                    self._jobs[job_id] = {
                        "finished": 1, "_done_at": time.time(),
                        "error": {"name": "JSONRPCError", "code": code,
                                  "message": str(ex)}}

        threading.Thread(target=work, daemon=True).start()
        return [job_id]

    def annotate_submit(self, params):
        return self._submit(self.annotate, params)

    def check_job(self, params):
        if not params:
            raise RpcError("_check_job expects a job id parameter")
        job_id = params[0]
        with self._jobs_lock:
            # Reap here too: a poll-only or idle server otherwise never
            # expires finished jobs and the async_jobs gauges go stale.
            self._reap_jobs()
            job = self._jobs.get(job_id)
        if job is None:
            raise RpcError(f"unknown job id {job_id!r} (finished jobs are "
                           f"kept {int(self.JOB_TTL_S)}s)")
        out = {k: v for k, v in job.items() if not k.startswith("_")}
        return [dict(out, job_id=job_id)]

    def dispatch(self, method: str, params):
        short = method.split(".", 1)[-1]
        fn = {"status": self.status, "annotate": self.annotate,
              "warm": self.warm,
              "_annotate_submit": self.annotate_submit,
              "_check_job": self.check_job}.get(short)
        if fn is None:
            # Fixed label: echoing the raw client string would let every
            # distinct bogus method mint a new counter key (unbounded
            # registry growth + metric-cardinality abuse).
            self.metrics.inc("rpc_requests_total",
                             {"method": "_unknown", "outcome": "no_such_method"})
            raise RpcError(f"Method {method} is not a valid method", -32601)
        self.metrics.add_gauge("rpc_requests_in_flight", 1)
        t0 = time.time()
        try:
            result = fn(params)
            outcome = "ok"
            return result
        except RpcError:
            outcome = "rpc_error"
            raise
        except Exception:
            outcome = "internal_error"
            raise
        finally:
            self.metrics.add_gauge("rpc_requests_in_flight", -1)
            self.metrics.observe("rpc_request_seconds", time.time() - t0,
                                 {"method": short})
            self.metrics.inc("rpc_requests_total",
                             {"method": short, "outcome": outcome})


def make_handler(service: KmerGutsService, token: Optional[str] = None,
                 access_log: Optional[str] = None,
                 max_body_bytes: int = 1 << 30,
                 auth=None):
    """``token``: shared bearer token; when set, requests must carry
    ``Authorization: <token>`` (the role of the reference's authclient.py —
    its KBase token cache — reduced to a static credential).
    ``auth``: an ``auth.AuthClient`` (or anything with ``get_user(token)
    -> user`` raising ``auth.AuthError``); when set it supersedes the
    static token and every request's Authorization header is resolved to
    a user through the external auth service, cached per the reference's
    TokenCache semantics (authclient.py:24-91).
    ``access_log``: path for an NCSA common-log-format request log (the
    reference's Jetty NCSARequestLog, jetty.xml:75-87).
    ``max_body_bytes``: reject larger uploads before buffering them (one
    inline-FASTA request is held fully in RAM; the cap keeps a single
    oversized client from taking the whole server down)."""
    log_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _log_access(self, code: int, nbytes: int):
            if access_log is None:
                return
            ts = self.log_date_time_string()
            line = (f'{self.client_address[0]} - - [{ts}] '
                    f'"{self.requestline}" {code} {nbytes}\n')
            with log_lock:
                with open(access_log, "a") as fh:
                    fh.write(line)

        def do_GET(self):
            """Operational endpoints (unauthenticated by design: they carry
            no annotation data and sit behind the deployment's scrape/probe
            plane — Prometheus and kubelet probes don't send app tokens)."""
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                payload = service.metrics.render().encode()
                code, ctype = 200, "text/plain; version=0.0.4"
            elif path == "/healthz":
                payload, code, ctype = b"ok\n", 200, "text/plain"
            elif path == "/readyz":
                ok, msg = service.ready()
                payload = (msg + "\n").encode()
                code, ctype = (200 if ok else 503), "text/plain"
            else:
                payload, code, ctype = b"not found\n", 404, "text/plain"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self._log_access(code, len(payload))
            self.wfile.write(payload)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            rpc_id = None
            if length > max_body_bytes:
                resp = {"version": "1.1", "id": None,
                        "error": {"name": "JSONRPCError", "code": -32002,
                                  "message": f"request body {length} B "
                                             f"exceeds limit {max_body_bytes} B"}}
                payload = json.dumps(resp).encode()
                # counted before the reply, so that a client's next
                # /metrics read sees it
                service.metrics.inc("rpc_requests_total",
                                    {"method": "_http",
                                     "outcome": "body_too_large"})
                self.send_response(413)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Connection", "close")
                self.end_headers()
                self._log_access(413, len(payload))
                self.wfile.write(payload)
                return
            body = self.rfile.read(length)
            try:
                req = json.loads(body)
                rpc_id = req.get("id")
                if auth is not None:
                    from .auth import AuthError

                    try:
                        auth.get_user(self.headers.get("Authorization") or "")
                    except AuthError as ex:
                        service.metrics.inc("rpc_requests_total",
                                            {"method": "_http",
                                             "outcome": "unauthorized"})
                        raise RpcError(f"Authorization required: {ex}",
                                       -32001)
                elif token is not None and \
                        self.headers.get("Authorization") != token:
                    service.metrics.inc("rpc_requests_total",
                                        {"method": "_http",
                                         "outcome": "unauthorized"})
                    raise RpcError("Authorization required", -32001)
                result = service.dispatch(req.get("method", ""),
                                          req.get("params", []))
                resp = {"version": "1.1", "result": result, "id": rpc_id}
                code = 200
            except RpcError as ex:
                resp = {"version": "1.1", "id": rpc_id,
                        "error": {"name": "JSONRPCError", "code": ex.code,
                                  "message": str(ex)}}
                code = 500
            except Exception as ex:  # noqa: BLE001 — servlet-style catch-all
                resp = {"version": "1.1", "id": rpc_id,
                        "error": {"name": "JSONRPCError", "code": -32603,
                                  "message": f"{type(ex).__name__}: {ex}"}}
                code = 500
            payload = json.dumps(resp).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self._log_access(code, len(payload))
            self.wfile.write(payload)

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


class PooledHTTPServer(ThreadingHTTPServer):
    """Bounded worker pool (the reference Jetty runs 5-200 threads,
    scripts/jetty.xml:12-17; ThreadingHTTPServer alone is unbounded)."""

    def __init__(self, addr, handler, max_workers: int = 32):
        from concurrent.futures import ThreadPoolExecutor

        super().__init__(addr, handler)
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="rpc")

    def process_request(self, request, client_address):
        self._pool.submit(self.process_request_thread,
                          request, client_address)

    def server_close(self):
        super().server_close()
        self._pool.shutdown(wait=False)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop accepting and wait up to ``timeout_s`` for in-flight
        requests to finish. Returns True if the pool drained in time."""
        self.shutdown()  # stops serve_forever's accept loop
        done = threading.Event()

        def waiter():
            self._pool.shutdown(wait=True)
            done.set()

        threading.Thread(target=waiter, daemon=True).start()
        drained = done.wait(timeout_s)
        super().server_close()
        return drained


def serve(data_dir: Optional[str], port: int = 5000,
          token: Optional[str] = None, access_log: Optional[str] = None,
          max_workers: int = 32, max_body_bytes: int = 1 << 30,
          auth=None, device: str = "cuda"):
    service = KmerGutsService(data_dir, device)
    server = PooledHTTPServer(
        ("0.0.0.0", port),
        make_handler(service, token, access_log, max_body_bytes, auth),
        max_workers=max_workers)
    server.service = service
    return server


def main(argv=None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(description="KmerGuts JSON-RPC server")
    ap.add_argument("-D", "--data-dir", default=None)
    ap.add_argument("-p", "--port", type=int, default=5000)
    ap.add_argument("--token", default=os.environ.get("KMER_SERVICE_TOKEN"),
                    help="require this Authorization header on all requests")
    ap.add_argument("--auth-url", default=os.environ.get("KMER_AUTH_URL"),
                    help="validate Authorization tokens against this auth "
                         "service (user_id lookup, 5-min token cache — the "
                         "reference authclient.py contract); supersedes "
                         "--token")
    ap.add_argument("--access-log", default=None,
                    help="append NCSA-format request log to this file")
    ap.add_argument("--max-workers", type=int, default=32,
                    help="request worker pool size (Jetty ran 5-200)")
    ap.add_argument("--max-body-bytes", type=int, default=1 << 30,
                    help="reject request bodies larger than this (HTTP 413)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="seconds to let in-flight requests finish on SIGTERM")
    ap.add_argument("--warm", action="store_true",
                    help="preload table + device planes before serving")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the probe: cuda (default; the "
                         "CUDA kernels) or cpu (their PyTorch twins)")
    args = ap.parse_args(argv)
    auth = None
    if args.auth_url:
        from .auth import AuthClient

        auth = AuthClient(args.auth_url)
    server = serve(args.data_dir, args.port, args.token, args.access_log,
                   args.max_workers, args.max_body_bytes, auth, args.device)
    if args.warm:
        st = server.service.warm([])[0]
        print(f"warm: num_sigs={st['num_sigs']} max_probe={st['max_probe']} "
              f"probe_window={st['probe_window']}")

    import signal

    stopping = threading.Event()

    def on_sigterm(signum, frame):
        # k8s-style graceful shutdown: stop accepting, drain, exit
        stopping.set()
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, on_sigterm)
    # the bound port, so that -p 0 (any free port) can be found
    print(f"serving on :{server.server_address[1]} "
          f"(data_dir={args.data_dir}, device={args.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    if stopping.is_set():
        drained = server.drain(args.drain_timeout)
        print("drained cleanly" if drained
              else f"drain timed out after {args.drain_timeout}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
