"""The check that decides ``correct``: the reference agrees with the
program, and the control and the planted faults come out not correct.

Every run here drives the whole of a cell's run on the CPU at a small
size (the command itself refuses the CPU): set-up, window, drain, the
records' arithmetic and the reference's replay of the sampled groups.
"""

from __future__ import annotations

import pytest
import torch

from cellbench import control, harness, manifest
from cellbench.reference import prng as rprng

CELLS = ["c5.skew_churn", "r3.uniform_steady", "c5.skew_steady", "r3.uniform_churn"]
SMALL = {"G": 48}
SECONDS = 0.4


def small_run(name, seed, step=None):
    cell = manifest.cell(name)
    return harness.run(cell, seed, SECONDS, False, "cpu", step=step, conf_override=SMALL)


@pytest.mark.parametrize("name", CELLS)
def test_program_equals_reference(name):
    out = small_run(name, 2**31 + 41)
    assert out.window.ticks > 0
    assert out.checks == {"state_diff": {"value": 0, "limit": 0},
                          "record_diff": {"value": 0, "limit": 0}}
    assert out.correct
    assert out.writes["accepted_committed"] > 0 and out.writes["unplaced"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = manifest.cell(name)
    conf = dict(cell.conf, **SMALL)
    out = small_run(name, 5, step=control.control_step(conf, "cpu"))
    assert not out.correct
    assert out.checks["state_diff"]["value"] > 0 or out.checks["record_diff"]["value"] > 0


def test_reference_with_the_sound_quorum_in_the_programs_place_is_correct():
    cell = manifest.cell("c5.skew_churn")
    conf = dict(cell.conf, **SMALL)
    out = small_run("c5.skew_churn", 6, step=control.control_step(conf, "cpu", commit_quorum=0))
    assert out.correct


def unchanged_state(step):
    def broken(cfg, st, mb, cmds, key):
        _, _, rec = step(cfg, st, mb, cmds, key)
        return st, mb, rec
    return broken


def half_the_groups(step):
    def broken(cfg, st, mb, cmds, key):
        st2, mb2, rec = step(cfg, st, mb, cmds, key)
        keep = torch.arange(cfg.G) < cfg.G // 2

        def mix(new, old):
            if new.dim() == 0:
                return new
            k = keep.reshape((-1,) + (1,) * (new.dim() - 1))
            return torch.where(k, new, old)

        st2 = st2._replace(**{f: mix(getattr(st2, f), getattr(st, f)) for f in st2._fields})
        rec = {k: torch.where(keep[None], v, 0) for k, v in rec.items()}
        return st2, mb2, rec
    return broken


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [unchanged_state, half_the_groups])
def test_a_broken_step_is_not_correct(name, fault):
    out = small_run(name, 9, step=fault(harness.program_step()))
    assert not out.correct


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_commit_answer_is_not_correct(name, monkeypatch):
    from multiraft_tpu_torch.engine import kernels

    real = kernels.quorum_commit

    def off_by_one(*args):
        out = real(*args)
        return out + args[6].to(out.dtype)  # every leader's commit one too far

    monkeypatch.setattr(kernels, "quorum_commit", off_by_one)
    out = small_run(name, 10)
    assert not out.correct


def test_reference_prng_is_the_programs():
    from multiraft_tpu_torch.utils import prng

    k = prng.fold_in(prng.PRNGKey(12345), 77)
    rk = rprng.fold_in(rprng.key(12345), 77)
    assert tuple(int(x) for x in k.tolist()) == rk
    full = prng.randint(k, (40, 5), 30, 60)
    rows = torch.tensor([0, 3, 17, 39])
    sub = rprng.randint(rk, rows[:, None] * 5 + torch.arange(5), 30, 60)
    assert torch.equal(full[rows], sub)
