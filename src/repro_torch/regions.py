"""Named regions of the program that a dispatch mode may see whole.

:func:`region` marks a function: a hand-written kernel's wrapper, or a
function whose interior a fused kernel keeps on chip (flash attention's
forward and backward, the SSD chunk scan).  A call to it runs the
function, unless a ``TorchDispatchMode`` on this thread's mode stack has
a ``region_call(fn, args, kwargs)`` method: the innermost such mode then
makes the call.  The mode stack is per thread, and autograd's threads
take the stack of the thread that called ``backward``, so a mode sees
the regions of the backward it caused and of no other thread.

``repro_torch.roofline.jaxpr_cost``'s walker is such a mode: it charges
a region as a whole.  What a mode does with a call is its own affair;
nothing here knows it.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def region(fn):
    """Mark ``fn`` as a region (see the module's docstring); the wrapper
    carries ``is_region``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if torch._C._len_torch_dispatch_stack():
            for mode in reversed(_get_current_dispatch_mode_stack()):
                call = getattr(mode, "region_call", None)
                if call is not None:
                    return call(fn, args, kwargs)
        return fn(*args, **kwargs)
    wrapped.is_region = True
    return wrapped
