"""One module per metric of BENCHMARK.json, named as the metric is (dots
and all), each with `read(run) -> float | None`.  `run.py` loads them by
file name; a reader that finds nothing to read returns None and the
metric is left out of the run's line."""
