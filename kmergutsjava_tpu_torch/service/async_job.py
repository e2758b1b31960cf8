"""One-shot async job runner.

Counterpart of the reference's async execution mode
(KmerGutsJavaServer.main(input.json, output.json, token) dispatched by
scripts/run_async.sh + entrypoint "async", ref KmerGutsJavaServer.java:47-59):
read a JSON-RPC request from a file, execute it, write the JSON-RPC response
to a file. The request runs on one torch device (``--device``, default
``cuda``; ``cpu`` runs the kernels' PyTorch twins).

Usage: python -m kmergutsjava_tpu_torch.service.async_job <input.json>
       <output.json> [-D data_dir] [--device cuda|cpu]
"""
from __future__ import annotations

import json
import sys

from .server import KmerGutsService, RpcError


def run_job(input_path: str, output_path: str, data_dir=None,
            device: str = "cuda") -> int:
    with open(input_path) as fh:
        req = json.load(fh)
    service = KmerGutsService(data_dir, device)
    rpc_id = req.get("id")
    try:
        result = service.dispatch(req.get("method", ""), req.get("params", []))
        resp = {"version": "1.1", "result": result, "id": rpc_id}
        rc = 0
    except RpcError as ex:
        resp = {"version": "1.1", "id": rpc_id,
                "error": {"name": "JSONRPCError", "code": ex.code,
                          "message": str(ex)}}
        rc = 1
    except Exception as ex:  # noqa: BLE001
        resp = {"version": "1.1", "id": rpc_id,
                "error": {"name": "JSONRPCError", "code": -32603,
                          "message": f"{type(ex).__name__}: {ex}"}}
        rc = 1
    with open(output_path, "w") as fh:
        json.dump(resp, fh)
    return rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = {"-D": None, "--device": "cuda"}
    for flag in opts:
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print("usage: async_job <input.json> <output.json> [-D data_dir] "
              "[--device cuda|cpu]", file=sys.stderr)
        return 2
    return run_job(argv[0], argv[1], opts["-D"], opts["--device"])


if __name__ == "__main__":
    raise SystemExit(main())
