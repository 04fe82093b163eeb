"""exchange_ms_per_step: host milliseconds a rank spent inside ``DistMesh``'s
``all_to_all`` calls (``DistMesh.stats.exchange``: the call itself, which
under NCCL enqueues the collective, and under gloo waits for the peers),
over the fold steps.  Nothing on a mesh without collectives."""


def read(r):
    if r.mesh is None or r.mesh["exchange"]["calls"] == 0:
        return None
    return r.mesh["exchange"]["seconds"] * 1e3 / r.steps
