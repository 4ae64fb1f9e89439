"""Profiler (so far the op registry's statistics, ``statistic``)."""
from . import statistic  # noqa: F401
