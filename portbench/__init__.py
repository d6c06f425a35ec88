"""portbench: the benchmark of ``spmm_tpu_torch``, the PyTorch/CUDA port.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on the card: ``python3 -m portbench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.  Configurations
(``configs/<name>.json``), traffic mixes (``traffic/<name>.json``, read by
the call kind they name in ``calls/``) and per-layer metrics
(``metrics/<name>.py``) are found by name, so a new cell needs only new
files and entries.  The yardstick (the frozen generator ``gen/``, the byte
counts and peaks ``counts/``, the plain references ``reference/`` and the
comparison ``judge.py``) imports nothing of the program.
"""
