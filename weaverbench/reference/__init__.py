"""Plain references for the traversals the benchmark checks: plain
PyTorch on the arrays the harness hands the port, importing nothing of
``repro_torch``."""
