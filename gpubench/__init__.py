"""The port's benchmark: see ``run.py`` and ``PERF.md``."""
