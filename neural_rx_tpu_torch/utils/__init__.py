"""Profiling (`profiling.py`) and numerical debugging (`debug.py`)."""

from .debug import debug_context, nan_guard
from .profiling import profile_trace, time_fn
