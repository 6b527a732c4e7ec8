"""Benchmarks of the PyTorch port (mirrors of the repository's
``benchmarks/``), written under ``build/bench/``, never over the
reference's ``BENCH_*.json``."""
