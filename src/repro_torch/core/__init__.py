"""Lattices, window assigners, CRDTs and Windowed CRDTs on stacked
replicas: the package-level names of ``repro.core``, each the port's
counterpart (a collective join across a mesh axis is a join over the
stacked replica axis of a ``StackMesh`` here)."""
from repro_torch.core.lattice import (
    Reduce,
    axis_join as lattice_axis_join,
    elementwise_join,
    float_to_ordered_u32,
    join,
    join_many,
    join_stacked,
    lattice_dataclass,
    lex_join,
    ordered_u32_to_float,
)
from repro_torch.core.crdt import (
    GCounter,
    GSet,
    LWWReg,
    MaxReg,
    MinReg,
    PNCounter,
    TopK,
)
from repro_torch.core.window import (
    Hopping,
    Tumbling,
    WindowAssigner,
    as_assigner,
    expand_events,
)
from repro_torch.core.wcrdt import (
    WSpec,
    WState,
    axis_join,
    axis_join_aligned,
    baseline_of,
    delta_axis_join,
    delta_nbytes,
    delta_since,
    global_watermark,
    increment_watermark,
    insert,
    merge,
    merge_delta_stack,
    state_nbytes,
    zero_baseline,
    wgcounter,
    wgset,
    window_complete,
    window_value,
    wmaxreg,
    wminreg,
    wpncounter,
    wtopk,
)

__all__ = [k for k in dir() if not k.startswith("_")]
