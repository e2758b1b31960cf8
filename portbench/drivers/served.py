"""The port's JSON-RPC server, in the run's process on a loopback port
(``service/server.py`` ``serve``, device cuda), driven by one client in a
closed loop: each ``annotate`` request is sent when the last has come
back, as a KBase app calls the service and waits.

Set-up: the server starts, ``warm`` loads the table and the default
lookup, then every request of the pool runs once (a fresh process's
first requests run slower while its allocator settles).
The window counts each request from before its body is encoded to after
the reply is decoded. ``/metrics`` is read before and after the window
for the server's own time (``rpc_request_seconds`` of ``annotate``).
"""
from __future__ import annotations

import http.client
import json
import threading
import time

from portbench.core.harness import Done

TRACED_REQUESTS = 24


def _call(port: int, method: str, params, timeout: float = 900.0):
    body = json.dumps({"version": "1.1", "method": "KmerGutsJava." + method,
                       "params": params, "id": "1"}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/", body=body,
                     headers={"Content-Type": "application/json"})
        reply = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    if "error" in reply:
        raise RuntimeError(reply["error"].get("message", "error"))
    return reply["result"]


def server_seconds(port: int, method: str = "annotate"):
    """(sum, count) of the server's ``rpc_request_seconds`` of ``method``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    got = {}
    for key in ("sum", "count"):
        head = f'rpc_request_seconds_{key}{{method="{method}"}} '
        got[key] = next((float(line[len(head):]) for line in
                         text.splitlines() if line.startswith(head)), 0.0)
    return got["sum"], got["count"]


def run(run) -> None:
    import torch
    from torch.profiler import record_function

    from kmergutsjava_tpu_torch.service.server import serve

    e = run.config["engine"]
    params = {"aa": e["aa"], "min_hits": e["min_hits"],
              "max_gap": e["max_gap"]}
    srv = serve(run.data_dir, port=0, device=run.device)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def stop():
        srv.shutdown()
        srv.server_close()
        thread.join(60)

    run.cleanups.append(stop)
    port = srv.server_address[1]

    def annotate(job) -> Done:
        start = time.time()
        try:
            got = _call(port, "annotate", [dict(params, fasta=job.text)])
            return Done(job, start, time.time(), True, report=got[0]["report"])
        except (OSError, RuntimeError, ValueError, KeyError) as ex:
            return Done(job, start, time.time(), False, error=repr(ex))

    _call(port, "warm", [])
    for job in run.jobs:
        if not annotate(job).ok:
            raise RuntimeError(f"warm-up request {job.name} failed")
    s0, n0 = server_seconds(port)
    run.closed_loop(annotate)
    s1, n1 = server_seconds(port)
    run.readings["server_s"], run.readings["server_n"] = s1 - s0, n1 - n0
    if run.device == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if run.trace:
        run.traced_jobs = run.jobs[:TRACED_REQUESTS]

        def traced():
            for job in run.traced_jobs:
                with record_function("portbench.request"):
                    annotate(job)

        run.traced(traced)
