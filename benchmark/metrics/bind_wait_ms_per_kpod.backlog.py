"""The bind worker's batches less its CPU seconds in them: its waits (bind_wall_s - bind_cpu_s), per 1,000 pods bound, ms."""

from benchmark.critical_path import field_difference, per_kpod


def read(trace):
    return per_kpod(trace, field_difference("bind_wall_s", "bind_cpu_s"))
