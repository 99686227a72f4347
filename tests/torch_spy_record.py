"""Run a spied caller once for several test cases: the ``*_align.py``
files' B/16-width callers, whose recorded operands the cases then assert
from.

The suite's workers share the machine's cores; a caller at B/16 widths
that runs torch on every core in each worker spends most of its time on
oversubscribed threads, so the runs here take one intra-op thread.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_thread():
    """torch at one intra-op thread inside the block, as before after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def record(run, keys) -> dict:
    """``{key: run(monkeypatch, *key)}``: each run once, its spies in a
    MonkeyPatch context of its own (undone after it), at one torch thread."""
    out = {}
    with one_thread():
        for key in keys:
            with pytest.MonkeyPatch.context() as mp:
                out[key] = run(mp, *key)
    return out
