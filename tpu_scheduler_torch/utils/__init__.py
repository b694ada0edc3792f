"""Host utilities of the PyTorch/CUDA port: metrics, tracing, events, the
cost-attribution profiler and GC tuning."""
