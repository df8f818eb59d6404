"""Corpus runner (corpus), multi-process helpers (distributed) and
profiling hooks (profiling)."""
