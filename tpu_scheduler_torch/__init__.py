"""tpu_scheduler_torch — the PyTorch/CUDA port of ``tpu_scheduler``.

The JAX package stays the reference; this package imports ``torch`` and
``numpy`` and nothing of ``tpu_scheduler`` or JAX.  It carries the flagship
cycle, unconstrained or with inter-pod constraints: ``synth_cluster`` →
``pack_snapshot`` (+ ``ops.constraints.pack_constraints``) →
``CudaBackend.schedule`` (ops/assign.py, with the hand-written choose
kernels of ``csrc/choose.cu`` on the card).  Topology cycles are not ported
yet.
"""
