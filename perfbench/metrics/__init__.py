"""One reader per metric, found by the metric's name in BENCHMARK.json:
`<name>.py` defines `read(rec) -> float or None` (None: nothing to read
in this run, and the metric is left out of the result line)."""
