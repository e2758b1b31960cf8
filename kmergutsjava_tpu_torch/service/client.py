"""JSON-RPC client (stdlib-only).

Counterpart of the reference's generated clients
(lib/KmerGutsJava/KmerGutsJavaClient.py and the Java/Perl/JS stubs — all of
which expose only ``status`` because the KIDL module is empty). This client
additionally drives the real ``annotate`` method our server exposes.
"""
from __future__ import annotations

import itertools
import json
import time
import urllib.request
from typing import Optional


class ServerError(RuntimeError):
    def __init__(self, name: str, code: int, message: str):
        super().__init__(f"{name} ({code}): {message}")
        self.name = name
        self.code = code


class KmerGutsClient:
    def __init__(self, url: str, timeout: float = 600.0,
                 token: Optional[str] = None):
        self.url = url
        self.timeout = timeout
        self.token = token  # role of the reference's authclient.py token
        self._ids = itertools.count(1)

    def _call(self, method: str, params):
        payload = json.dumps({
            "version": "1.1",
            "method": f"KmerGutsJava.{method}",
            "params": params,
            "id": str(next(self._ids)),
        }).encode()
        headers = {"Content-Type": "application/json"}
        if self.token is not None:
            headers["Authorization"] = self.token
        req = urllib.request.Request(self.url, data=payload, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = json.load(resp)
        except urllib.error.HTTPError as ex:
            body = json.load(ex)
        if "error" in body and body["error"]:
            err = body["error"]
            raise ServerError(err.get("name", "JSONRPCError"),
                              err.get("code", -32000),
                              err.get("message", ""))
        return body["result"]

    def status(self) -> dict:
        return self._call("status", [])[0]

    def warm(self) -> dict:
        return self._call("warm", [])[0]

    @staticmethod
    def _annotate_params(fasta, fasta_path, options) -> dict:
        params = dict(options)
        if fasta is not None:
            params["fasta"] = fasta
        elif fasta_path is not None:
            params["fasta_path"] = fasta_path
        else:
            raise ValueError("fasta or fasta_path required")
        return params

    def annotate(self, fasta: Optional[str] = None,
                 fasta_path: Optional[str] = None, **options) -> str:
        params = self._annotate_params(fasta, fasta_path, options)
        return self._call("annotate", [params])[0]["report"]

    # -- async-job protocol (ref baseclient.py:_submit_job/_check_job) ------

    def annotate_submit(self, fasta: Optional[str] = None,
                        fasta_path: Optional[str] = None, **options) -> str:
        params = self._annotate_params(fasta, fasta_path, options)
        return self._call("_annotate_submit", [params])[0]

    def check_job(self, job_id: str) -> dict:
        return self._call("_check_job", [job_id])[0]

    def annotate_async(self, fasta: Optional[str] = None,
                       fasta_path: Optional[str] = None, **options) -> str:
        """Submit + poll until done. Backoff mirrors the reference JS client
        (lib/javascript/Client.js:13-16: 100 ms, x1.5, cap 5 min)."""
        job_id = self.annotate_submit(fasta, fasta_path, **options)
        delay = 0.1
        while True:
            job = self.check_job(job_id)
            if job.get("finished"):
                if job.get("error"):
                    err = job["error"]
                    raise ServerError(err.get("name", "JSONRPCError"),
                                      err.get("code", -32000),
                                      err.get("message", ""))
                return job["result"][0]["report"]
            time.sleep(delay)
            delay = min(delay * 1.5, 300.0)
