"""Entry: ``mh_tpu_torch.api.suggest_layouts``, called as
``suggest_layouts.py`` calls it, judged by ``portbench/reference/guidelines.py``:
the same plain reference with each guideline table evaluated at once, for
scenes with many clearances and relationships, whose replay by
``reference/fused.py`` takes minutes of host dispatch (bitwise the same
results, ``portbench/tests/test_portbench_guidelines.py``).
"""

from __future__ import annotations

import types

from portbench.entries import suggest_layouts as base
from portbench.entries.suggest_layouts import (  # noqa: F401  (the entry's API)
    call, proposals, record, setup, steps)
from portbench.reference import guidelines as rg

# suggest_layouts' replay and objective, with its reference module ``rf``
# bound to reference/guidelines.py
_names = {**vars(base), "rf": rg}
expected = types.FunctionType(base.expected.__code__, _names, "expected")
objective = types.FunctionType(base.objective.__code__, _names, "objective")
