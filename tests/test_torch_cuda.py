"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip without
them.  On a machine with a card, run them with::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from multiraft_tpu_torch import convert
from multiraft_tpu_torch.engine import kernels
from multiraft_tpu_torch.engine.core import EngineConfig
from multiraft_tpu_torch.engine.host import EngineDriver

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _commit_inputs(rng, G, P, L):
    base = rng.integers(0, 5, (G, P)).astype(np.int32)
    last = base + rng.integers(0, L - 6, (G, P)).astype(np.int32)
    return (
        rng.integers(-2, 20, (G, P, P)).astype(np.int32).clip(max=last[..., None]),
        rng.integers(1, 6, (G, P)).astype(np.int32),
        np.minimum(rng.integers(0, 10, (G, P)), last).astype(np.int32),
        base,
        rng.integers(0, 6, (G, P)).astype(np.int32),
        rng.integers(1, 6, (G, P, L)).astype(np.int32),
        rng.random((G, P)) < 0.4,
    )


@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 7, 8, 9, 32])
def test_kernels_equal_plain_versions(card, P):
    rng = np.random.default_rng(P)
    G, L, quorum = 37, 16, P // 2 + 1
    args = [torch.from_numpy(a).to(card) for a in _commit_inputs(rng, G, P, L)]
    got = kernels.quorum_commit(*args, quorum)
    assert torch.equal(got, kernels.quorum_commit_plain(*args, quorum))
    votes = torch.from_numpy(rng.random((G, P, P)) < 0.5).to(card)
    role = torch.from_numpy(rng.integers(0, 3, (G, P)).astype(np.int32)).to(card)
    alive = torch.from_numpy(rng.random((G, P)) < 0.8).to(card)
    got = kernels.vote_tally(votes, role, alive, quorum)
    assert torch.equal(got, kernels.vote_tally_plain(votes, role, alive, quorum))
    torch.cuda.synchronize()


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    votes = torch.zeros((4, 33, 33), dtype=torch.bool, device=card)
    role = torch.zeros((4, 33), dtype=torch.int32, device=card)
    alive = torch.ones((4, 33), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="P <= 32"):
        kernels.vote_tally(votes, role, alive, 17)
    votes = torch.zeros((4, 3, 3), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.vote_tally(votes, role[:, :3].t().contiguous().t(), alive[:, :3], 2)


def test_engine_on_the_card_equals_the_engine_on_the_cpu(card):
    cfg = EngineConfig(G=16, P=3, L=32, E=4, INGEST=4, use_kernels=True)
    worlds = []
    for dev in (card, "cpu"):
        d = EngineDriver(cfg, seed=6, device=dev)
        d.start_bulk(np.full(cfg.G, 200, np.int64))
        d.step(40)
        d.drop_prob = 0.1
        d.step(40)
        worlds.append((d.np_state(), convert.mailbox_to_numpy(d.inbox)))
    for a, b in zip(*worlds):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
