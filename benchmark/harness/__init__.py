"""The benchmark's core: it reads cells from ``BENCHMARK.json`` and names no
cell, configuration or metric of its own."""
