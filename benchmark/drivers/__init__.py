"""Traffic drivers, one module per ``driver`` key of a traffic file. Each
has ``run(cell, seed, seconds, trace, device, control=False)`` returning a
``benchmark.harness.Run`` and ``judge(cell, run)`` returning the compared
numbers."""
