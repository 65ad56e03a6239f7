"""Comparisons shared by the port's parity tests (numpy only, no JAX).

Imported as ``torch_parity`` (pytest puts ``tests/`` on ``sys.path``),
not as ``tests.torch_parity``: an installed regular package named
``tests`` would shadow this directory's namespace package."""

import numpy as np


def same_delayed(a, b) -> bool:
    """Whether two reorder delay queues hold the same messages in the same
    order: release tick, peer, edge and every field of the held frame,
    dtype included."""
    if len(a) != len(b):
        return False
    for (ra, pa, ea, fa), (rb, pb, eb, fb) in zip(a, b):
        if (ra, pa, ea) != (rb, pb, eb) or list(fa) != list(fb):
            return False
        for k in fa:
            x, y = np.asarray(fa[k]), np.asarray(fb[k])
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
    return True
