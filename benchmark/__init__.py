"""The benchmark of fft_restoration_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once and prints one JSON line. Every
cell, configuration, traffic mix, metric and limit is a file of its own
that the harness finds by its name (`spec.py`):

  configs/<config>.json    the deployment: frame size, restore options, PSF
  traffic/<traffic>.json   the mix: loop kind, pools, PSF schedule, sample
  metrics/<metric>.py      read(run) -> value or None, for every metric
  limits/<cell>.json       the limit of each number `correct` compares
  reference/<name>.py      prepare(...), restore(...): the plain float64
                           restore a configuration's frames are held to,
                           named by its "reference" key (default restore.py)

`roofline/` the counts of the restore's work and the card's peaks. The
benchmark drives the port only, and never imports JAX or the JAX package.
"""
