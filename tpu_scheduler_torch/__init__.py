"""tpu_scheduler_torch — the PyTorch/CUDA port of ``tpu_scheduler``.

The JAX package stays the reference; this package imports ``torch`` and
``numpy`` and nothing of ``tpu_scheduler`` or JAX.  It carries the flagship
cycle, unconstrained, with inter-pod constraints, with the topology
(gang-locality) term, or both: ``synth_cluster`` → ``pack_snapshot`` (+
``ops.constraints.pack_constraints``, + ``topology.pack_topology``) →
``CudaBackend.schedule`` (ops/assign.py, with the hand-written choose
kernels of ``csrc/choose.cu`` on the card, and an upload cache keyed by
host-array identity); the same cycle sharded over a (dp, tp) mesh of
devices (``parallel.sharded.ShardedBackend``, topology-blind as in the JAX
package); the choose kernel's bisection kernels (``ops/bisect.py``,
``csrc/bisect.cu``, driven by ``experiments/``); and the controller above
them — ``runtime.controller.Scheduler`` with its reflector, in-process API
server, resilience, metrics, events, tracing and profiler, through the
delta engine by default — its CLI, ``python -m tpu_scheduler_torch.cli``,
and the simulator above it (``sim/``: a seeded discrete-event harness of
named scenarios, ``python -m tpu_scheduler_torch.cli sim``).
"""
