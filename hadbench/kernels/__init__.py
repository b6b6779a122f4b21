"""Frozen work formulas of the port's hand-written kernels, one module a
kernel: ``NAMES`` (substrings of its CUDA kernels' names in a profiler
trace) and ``step_bound_s(step, shapes)``, the least seconds its launches
in one serving step need (``hadbench.peaks.bound_s`` of each launch)."""
