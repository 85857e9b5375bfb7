"""The benchmark of `tinaural_torch`: `run.py` runs one cell of
`BENCHMARK.json`, and every cell, configuration, traffic mix, entry point
and metric is a file here that the harness finds by its name."""
