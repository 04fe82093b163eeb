"""wire_bytes_per_step: the bytes a rank handed ``DistMesh``'s collectives
in the window (its gathers and its exchanges, ``DistMesh.stats``), over the
fold steps.  Nothing on a mesh without collectives."""


def read(r):
    if r.mesh is None:
        return None
    return (r.mesh["gather"]["sent_bytes"] + r.mesh["exchange"]["sent_bytes"]) / r.steps
