"""The plain reference that decides ``correct``.

Plain PyTorch, device-agnostic, importing nothing of the program under
test: :mod:`.prng` is a frozen copy of the Threefry-2x32 generator and
:mod:`.tick` a frozen copy of the batched Raft tick's plain path (both
from commit 73b8d79 of ``multiraft_tpu_torch``), written so that any
subset of groups can be replayed on its own.
"""
