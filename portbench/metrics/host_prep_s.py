"""host_prep_s: seconds of the port's host prep in set-up, by the host
clock: the CSR build (graph/csr.py) and the packed tables' build and
upload (ops/sampling.device_put_graph, native/), waited for. Moves
setup_s."""


def read(run):
    return run.host_prep_s
