"""The benchmark of decompdiff_tpu_torch (BENCHMARK.json at the repository
root names its cells, metrics and bounds).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Layout, each piece found by the names in BENCHMARK.json:
  configs/<config>.json     a model configuration as run
  traffic/<traffic>.json    a traffic mix: the parameters the one generator
                            (data/generator.py) and its driver read
  drivers/<kind>.py         the driver of traffic of one kind (the traffic
                            file's `kind`): set-up, window, the reference in
                            the program's place, the compared numbers
  limits/<workload>.json    the limits of a cell's correctness comparison
  metrics/<metric>.py       the reader of one per-layer metric
  core/                     the harness: cells, window, trace, result line
  counts/                   operations and bytes of the work, and the peaks
  data/                     the complex generator and the size table
  reference/                the plain PyTorch reference and the comparison
  calibrate.py              the readings the limits were set from, judged
  rehearse.py               a cell on the CPU at a tiny size
  tests/                    the benchmark's own tests (not in tests/)
"""
