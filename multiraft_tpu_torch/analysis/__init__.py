"""graftlint: project-native static analysis for the PyTorch port
(port of ``multiraft_tpu/analysis``).

``python -m multiraft_tpu_torch.analysis`` lints this package with every
registered rule (the reference's 14 host-code rules; its two JAX rules,
``donated-alias`` and ``jit-purity``, have no counterpart here), and
``tests/test_torch_analysis.py`` holds it to zero unsuppressed findings.

See :mod:`.core` for the framework, :mod:`.rules` for the per-bug-class
rules, :mod:`.lockgraph` for the static lock audit, :mod:`.planes` and
:mod:`.registry` for the contract-drift rules (state-plane lifecycle,
record/chaos/capability/knob registries) and :mod:`.lockorder` for the
dynamic lock-order recorder the runtime sanitizer installs
(``MRT_SANITIZE=1``).
"""

from .core import ALL_RULES, Finding, ModuleInfo, Project, Rule, run
from . import rules as _rules  # noqa: F401  (registration side effect)
from . import lockgraph as _lockgraph  # noqa: F401
from . import dataflow as _dataflow  # noqa: F401
from . import planes as _planes  # noqa: F401
from . import registry as _registry  # noqa: F401
from .dataflow import Dataflow, get_dataflow
from .lockgraph import LockGraph
from .lockorder import LockOrderRecorder, RecordingLock

__all__ = [
    "ALL_RULES",
    "Dataflow",
    "Finding",
    "ModuleInfo",
    "Project",
    "Rule",
    "get_dataflow",
    "run",
    "LockGraph",
    "LockOrderRecorder",
    "RecordingLock",
]
