"""The benchmark of ``tpuseg_torch`` on NVIDIA H100 cards.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
as one JSON line. Everything a cell is made of is found by name:
``configs/<config>.json`` (the model and its settings), ``traffic/<mix>.json``
(the generator's parameters), ``workloads/<cell>.json`` (the cell's own
settings and the limits of its output check), ``arch/<arch>.py`` (an
architecture: the program's model, its state, its plain reference forward
and its work), ``generators/<generator>.py`` (a traffic generator) and
``metrics/<metric>.py`` (one per-layer metric's reader). The yardstick
lives here too: the traffic generators (``gen.py``, ``generators/``), the
work counts and the card's peaks (``work.py``), the trace reduction
(``tracing.py``) and the plain reference that decides ``correct``
(``reference/`` and each architecture's ``forward``), which imports nothing
of the program.
"""
