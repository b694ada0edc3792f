"""tpu_scheduler_torch — the PyTorch/CUDA port of ``tpu_scheduler``.

The JAX package stays the reference; this package imports ``torch`` and
``numpy`` and nothing of ``tpu_scheduler`` or JAX.  This slice carries the
flagship unconstrained cycle: ``synth_cluster`` → ``pack_snapshot`` →
``CudaBackend.schedule`` (ops/assign.py, with the hand-written choose kernel
``csrc/choose.cu`` on the card).
"""
