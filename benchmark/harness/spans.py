"""The harness's spans: each call a kind's driver makes into the program
is a ``perf_counter`` interval in the driver's log and, in a traced run,
also a ``record_function`` range, so that the trace's device operations
line up with it (``harness/trace.py`` names idle gaps by them)."""

from __future__ import annotations

import contextlib


class Spans:
    """Opens a ``record_function`` range per span while tracing."""

    def __init__(self):
        self.tracing = False

    def __call__(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)
