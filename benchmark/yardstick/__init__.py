"""The benchmark's frozen yardstick: peaks, cost models, timers, the
profiler capture and its reduction, FLOP counting, and the kernel-name
group tables. Copied from the port's `chip_smoke.py` so that a change to
the program cannot move the ruler it is measured by."""
