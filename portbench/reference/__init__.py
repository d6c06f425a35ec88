"""Plain references: straightforward PyTorch over the benchmark's own inputs.
They import nothing of the program and recompute everything the program
derived (its packs, plans and tables) from those inputs.  Each takes a
``dtype``: float64 for the reference, bfloat16 for the control that must fail
the comparison."""
