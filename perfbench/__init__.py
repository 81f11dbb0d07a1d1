"""The benchmark of ``torchebm_tpu_torch`` on CUDA cards.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix, per-layer metric or cell sits
in a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the configuration as it is run; its ``system``
  names the constructor under ``systems/`` and its ``reference`` the plain
  reference under ``reference/``;
- ``traffic/<traffic>.json``: the mix's parameters; its ``entry`` names the
  entry under ``entries/`` and its ``inputs`` what :mod:`perfbench.generate`
  draws;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``limits/<workload>.json``: the limits of the cell's correctness numbers.

The yardstick lives here and nowhere in the program: the traffic generator,
the profiler's reduction (:mod:`perfbench.trace`), the table of peaks
(``peaks.json``) and of kernel classes (``kernel_classes.json``), the frozen
work counts (``counts/``) and the plain references (``reference/``). Nothing
here imports JAX or the JAX package.
"""
