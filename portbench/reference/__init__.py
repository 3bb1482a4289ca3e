"""Plain PyTorch reference of KPFusion for the benchmark: imports nothing
of the program under test."""
