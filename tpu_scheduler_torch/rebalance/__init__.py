"""Background rebalancer — in the port, only what every scorecard reads.

The sim scorecard's ``rebalance`` block judges packing efficiency on the
final cluster state whether or not a rebalancer ran, and the ``policy``
block folds that efficiency in.  So the port carries, as copies of the
JAX package's host code: ``RebalanceSnapshot`` (``snapshot.py``),
``packing_stats`` (``solver.py``) and the drained-node label
``REBALANCE_CORDON_LABEL`` (``tpu_scheduler/rebalance/executor.py:51``).
The solve, the planner, the executor and the what-if — the rebalancer
itself — wait for ROADMAP Queue 1 item 9.
"""

from .snapshot import RebalanceSnapshot
from .solver import packing_stats

__all__ = ["REBALANCE_CORDON_LABEL", "RebalanceSnapshot", "packing_stats"]

# Node-label marker on rebalancer-drained (cordoned) nodes: distinguishes
# them from operator cordons, survives crashes, and names the scale-down
# candidate set the autoscaler what-if reads (the scorecard's rebalance
# block counts them once the what-if is ported, with item 9).
REBALANCE_CORDON_LABEL = "rebalance.tpu-scheduler/drained"
