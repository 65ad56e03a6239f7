"""The port's kernel module (multiraft_tpu_torch/engine/kernels.py)
against the reference's Pallas kernels (interpret mode) and the jnp
formula of tests/test_pallas_ops.py, on the same numpy inputs.

Every plane is int32 or bool, so every comparison is exact.  The CUDA
kernels themselves cannot run here (no nvcc, no card): chip_smoke.py
holds them against these plain versions on the card.  What runs here
is the plain version, and the wrapper's dispatch of a CPU tensor to it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiraft_tpu.engine.pallas_ops import quorum_commit_pallas, vote_tally_pallas
from multiraft_tpu_torch.engine import kernels

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)


def _jnp_commit(eff_match, term, commit, base, base_term, log_term, is_leader, quorum):
    # The reference formula of tests/test_pallas_ops.py: sort, take the
    # quorum median, guard on its term.
    P = eff_match.shape[1]
    L = log_term.shape[-1]
    q = jnp.sort(eff_match, axis=-1)[:, :, P - quorum]
    ring = jnp.take_along_axis(log_term, jnp.mod(q, L)[..., None], axis=-1)[..., 0]
    q_term = jnp.where(q == base, base_term, ring)
    return jnp.where(is_leader & (q_term == term), jnp.maximum(commit, q), commit)


def _commit_inputs(rng, G, P, L):
    base = rng.integers(0, 5, (G, P)).astype(np.int32)
    log_len = rng.integers(0, L - 6, (G, P)).astype(np.int32)
    last = base + log_len
    eff_match = np.minimum(
        rng.integers(0, 20, (G, P, P)).astype(np.int32), last[..., None]
    )
    term = rng.integers(1, 6, (G, P)).astype(np.int32)
    commit = np.minimum(rng.integers(0, 10, (G, P)).astype(np.int32), last)
    base_term = rng.integers(0, 6, (G, P)).astype(np.int32)
    log_term = rng.integers(1, 6, (G, P, L)).astype(np.int32)
    is_leader = rng.random((G, P)) < 0.4
    return eff_match, term, commit, base, base_term, log_term, is_leader


@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("trial", range(5))
def test_quorum_commit_plain_matches_pallas_and_jnp(P, trial):
    rng = np.random.default_rng(100 * P + trial)
    G, L, quorum = 37, 16, P // 2 + 1  # odd G: the Pallas path pads
    args = _commit_inputs(rng, G, P, L)
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(
        quorum_commit_pallas(*jargs, quorum, interpret=True, block_g=16)
    )
    ref = np.asarray(_jnp_commit(*jargs, quorum))
    targs = [torch.from_numpy(a) for a in args]
    plain = kernels.quorum_commit_plain(*targs, quorum)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), pallas)
    np.testing.assert_array_equal(plain.numpy(), ref)


@pytest.mark.parametrize("P", [3, 5, 7])
def test_quorum_commit_counting_identity_with_negative_and_tied_matches(P):
    """Ties, equal rows and values below zero: the counting identity's
    zero fill for ineligible lanes must agree with the Pallas kernel."""
    rng = np.random.default_rng(7 + P)
    G, L, quorum = 29, 16, P // 2 + 1
    args = list(_commit_inputs(rng, G, P, L))
    args[0] = rng.integers(-3, 4, (G, P, P)).astype(np.int32)
    args[0][::3] = args[0][::3, :, :1]  # rows of equal entries
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(
        quorum_commit_pallas(*jargs, quorum, interpret=True, block_g=16)
    )
    plain = kernels.quorum_commit_plain(*[torch.from_numpy(a) for a in args], quorum)
    np.testing.assert_array_equal(plain.numpy(), pallas)


@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("trial", range(5))
def test_vote_tally_plain_matches_pallas(P, trial):
    rng = np.random.default_rng(1000 + 10 * P + trial)
    G, quorum = 41, P // 2 + 1
    votes = rng.random((G, P, P)) < 0.5
    role = rng.integers(0, 3, (G, P)).astype(np.int32)
    alive = rng.random((G, P)) < 0.8
    want = np.asarray(
        vote_tally_pallas(
            jnp.asarray(votes), jnp.asarray(role), jnp.asarray(alive),
            quorum, interpret=True, block_g=16,
        )
    )
    ref = (role == 1) & alive & (votes.sum(axis=-1) >= quorum)
    got = kernels.vote_tally_plain(
        torch.from_numpy(votes), torch.from_numpy(role),
        torch.from_numpy(alive), quorum,
    )
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(5)
    G, P, L = 37, 5, 16
    args = [torch.from_numpy(a) for a in _commit_inputs(rng, G, P, L)]
    votes = torch.from_numpy(rng.random((G, P, P)) < 0.5)
    role = torch.from_numpy(rng.integers(0, 3, (G, P)).astype(np.int32))
    alive = torch.from_numpy(rng.random((G, P)) < 0.8)
    kernels.reset_launches()
    assert torch.equal(
        kernels.quorum_commit(*args, 3), kernels.quorum_commit_plain(*args, 3)
    )
    assert torch.equal(
        kernels.vote_tally(votes, role, alive, 3),
        kernels.vote_tally_plain(votes, role, alive, 3),
    )
    # The counters count kernel launches only; the CPU path launches none.
    assert kernels.LAUNCHES == {"quorum_commit": 0, "vote_tally": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    votes = torch.zeros((2, 3, 3), dtype=torch.bool, device="meta")
    role = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    alive = torch.zeros((2, 3), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.vote_tally(votes, role, alive, 2)


def test_kernel_sources_ship_with_the_package():
    for src in kernels.SOURCES:
        text = src.read_text()
        assert 'extern "C"' in text
        assert "cudaGetLastError" in text
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
