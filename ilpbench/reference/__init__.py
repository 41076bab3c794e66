"""The plain reference of the benchmark: NumPy and plain PyTorch, with
nothing of the program under test.

- ``instance``: an instance as the generators give it (LP text and arrays);
- ``check``: every row of a solution, its objective;
- ``lagrangian``: the instance's Lagrangian lower bound (subgradient);
- ``tables``: the sweep's row and cost tables worked out from the
  instance, in the program's layout, and held against the program's;
- ``sweep_fused`` and ``sweep_general``: frozen copies of the two sweeps'
  semantics, run again at a state kept from the timed window;
- ``exchange``: the top-K population exchange between ranks, worked out
  again from every rank's population before it.
"""
