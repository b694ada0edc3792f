"""Topology-aware gang placement — the port of ``tpu_scheduler/topology/``.

``model.py`` declares the slice / rack interconnect hierarchy (from node
labels or a ``--topology-file`` spec) and compiles it per node set;
``locality.py`` packs the per-cycle tensors (NumPy) and computes the
per-round inputs of the gang co-placement score term from per-(gang,
domain) state, its dense plain version and the state update (torch).
"""

from .locality import (
    SCORING_KNOBS,
    GangTerm,
    TopologySet,
    gang_cycle_operands,
    gang_placement_stats,
    gang_round_operands,
    gang_state_update,
    gang_state_zeros,
    gang_topology_term,
    pack_topology,
)
from .model import (
    DEFAULT_LEVEL_KEYS,
    CompiledTopology,
    TopologyLevel,
    TopologyModel,
    load_topology_file,
)

__all__ = [
    "CompiledTopology",
    "DEFAULT_LEVEL_KEYS",
    "SCORING_KNOBS",
    "GangTerm",
    "TopologyLevel",
    "TopologyModel",
    "TopologySet",
    "gang_cycle_operands",
    "gang_placement_stats",
    "gang_round_operands",
    "gang_state_update",
    "gang_state_zeros",
    "gang_topology_term",
    "load_topology_file",
    "pack_topology",
]
