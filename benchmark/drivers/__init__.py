"""Traffic drivers. A traffic file names its driver (`"driver": "eval"` is
`drivers/eval.py`); each driver module defines `Driver`, built by
`benchmark.run` as `Driver(cell, seed, device, count_flops, overrides)`:

  * construction is the set-up: seeded weights and clips on the device,
    the program's entry or step built and warmed up on every shape the
    window uses;
  * `unit()` is one timed call or step and `sync()` waits for the card;
    `measure(start, end)` gives the end-to-end metrics of the units run
    between those host-clock times, `failures(units)` how many failed;
  * `trace_unit()` is the unit as the traced window runs it, and
    `trace_context()` what the cell's per-layer readers need;
  * `release()` frees the program's state; `readings(ops)` then runs the
    plain reference and returns each compared number (with `ops`, the
    control in the program's place).
"""
