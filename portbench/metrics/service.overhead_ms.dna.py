"""DNA requests: mean client-side request time less the mean of the server's
own rpc_request_seconds of annotate (HTTP, JSON, the engine lock's queue)."""
from portbench.core import readers


def read(run):
    return readers.service_overhead_ms(run)
