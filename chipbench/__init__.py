"""chipbench: the benchmark of ``repro_torch`` on one NVIDIA H100.

``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` through the port's
continuous-batching engine and prints one JSON result line.

Everything is found by name, so a configuration, a cell or a metric is
added by adding files:

* ``configs/<config>.json``: a model configuration (the port's config
  name, the dtype, the published source and every departure from it);
* ``traffic/<traffic>.json``: a traffic mix (the loop, the engine's
  geometry, the length distributions, the sampled share), which one
  generator (``traffic.py``) reads;
* ``workloads/<cell>.json``: a cell's own settings (the profiled steps,
  the correctness check's sample and limits);
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  metric, ``read(ctx) -> float | None``;
* ``reference/<family>.py``: a plain fp32 PyTorch forward per family.

``calibrate.py`` reads the numbers the limits are set from (the
program's and the control's) on the card.  ``costs/`` holds the
yardstick's arithmetic (the kernels' bounds, the
model FLOPs per token, the card's peaks).  Nothing here imports JAX or
the JAX package, and nothing under ``reference/`` imports the port.
"""
