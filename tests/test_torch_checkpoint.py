"""Checkpoints of the port's EngineDriver (``save``/``restore``), within
the port and across packages.

A port checkpoint restored under faults, with reorder messages held,
continues equal to the uninterrupted driver.  A reference checkpoint
restored by the port, and a port checkpoint restored by the reference,
continue equal to the driver they were taken from for 50 faulted ticks.
The reference reads a port checkpoint through the inverse of
``convert.CHECKPOINT_CLASSES``, built here: nothing in the reference
changes for it.  The guards (version, batches in flight, atomic
replace, mesh checkpoints, classes without a counterpart) raise, and a
``BatchedKV`` carried in ``extra`` comes back with every acknowledged
write, its recorded history linearizable by the reference's checker.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from multiraft_tpu.engine.core import EngineConfig as JaxConfig
from multiraft_tpu.engine.host import EngineDriver as JaxDriver
from multiraft_tpu.engine.kv import BatchedKV as JaxKV
from multiraft_tpu.engine.kv import KVOp as JaxOp
from multiraft_tpu.porcupine.kv import KvInput, KvOutput, kv_model
from multiraft_tpu.porcupine.model import Operation
from multiraft_tpu.porcupine.visualization import assert_linearizable
from multiraft_tpu_torch import convert
from multiraft_tpu_torch.engine.core import EngineConfig
from multiraft_tpu_torch.engine.host import EngineDriver
from multiraft_tpu_torch.engine.kv import BatchedKV, KVOp
from multiraft_tpu_torch.porcupine.types import OP_APPEND
from torch_parity import same_delayed

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

SHAPE = dict(G=4, P=3, L=32, E=4, INGEST=4)


def norm(x):
    """A package-neutral form of a payload structure: dataclasses and
    payload carriers by class name and fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x)
        )
    if type(x).__name__ in ("PayloadSlice", "PayloadRun"):
        return (type(x).__name__, np.asarray(x.rows).tolist(),
                getattr(x, "consumed", None))
    if isinstance(x, (tuple, list)):
        return tuple(norm(v) for v in x)
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    return x


def world(d):
    """Everything a checkpoint carries, as plain numpy and Python."""
    st = d.np_state()
    ib = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in d.inbox._asdict().items()}
    return dict(
        planes={**{"s." + k: v for k, v in st.items()},
                **{"i." + k: v for k, v in ib.items()}},
        tick=d.tick, backlog=d.backlog.tolist(), payloads=norm(d.payloads),
        pending=norm({g: v for g, v in d._pending_payloads.items() if v}),
        max_bound=d._max_bound, commits=d.commits_total,
        rng=d._np_rng.bit_generator.state, delayed=d._delayed,
        edge_up=d.edge_up.tolist(), drop=d.drop_prob,
        reorder=(d.reorder_prob, d.reorder_min, d.reorder_max),
    )


def assert_same(a, b, where) -> None:
    wa, wb = world(a), world(b)
    for k, v in wa["planes"].items():
        w = wb["planes"][k]
        assert v.dtype == w.dtype and np.array_equal(v, w), (where, k)
    assert same_delayed(wa.pop("delayed"), wb.pop("delayed")), (where, "delayed")
    wa.pop("planes"), wb.pop("planes")
    for k in wa:
        assert wa[k] == wb[k], (where, k)


def faults(drivers, t):
    """A fixed fault script, the same calls on every driver."""
    for d in drivers:
        if t == 3:
            d.restart_replica(1, 0)
        if t == 7:
            d.partition_replica(2, 1, False)
        if t == 12:
            d.set_alive(3, 2, False)
        if t == 20:
            d.partition_replica(2, 1, True)
            d.restart_replica(3, 2)
        if t == 30:
            d.drop_prob = 0.05


def port_driver(seed):
    return EngineDriver(EngineConfig(use_kernels=True, **SHAPE), seed=seed,
                        device="cpu")


def jax_driver(seed):
    return JaxDriver(
        JaxConfig(use_pallas=True, pallas_interpret=True, **SHAPE), seed=seed
    )


def chaos(d):
    d.set_reorder(0.5, 2, 6)
    d.drop_prob = 0.2
    d.partition_replica(1, 0, False)


def test_port_checkpoint_under_faults_continues_equal(tmp_path):
    a = port_driver(11)
    chaos(a)
    for t in range(40):
        a.start(t % 4, ("cmd", t))
        a.step()
    assert a._delayed, "nothing held in the reorder queue at the save"
    path = str(tmp_path / "port.ckpt")
    a.save(path)
    b = EngineDriver.restore(path, device="cpu")
    assert b.state.term.device.type == "cpu"
    assert_same(a, b, "restored")
    for t in range(60):
        faults((a, b), t)
        for d in (a, b):
            if t % 2 == 0:
                d.start(t % 4, ("post", t))
            d.step()
        assert_same(a, b, t)
    assert b.commits_total > 0


def _kv_round(pairs, t, fault_t):
    """One tick of appends to group t % 4 through each (driver, kv) pair,
    after the fault script's step ``fault_t``."""
    faults([d for d, _ in pairs], fault_t)
    for d, kv in pairs:
        op = JaxOp if isinstance(d, JaxDriver) else KVOp
        kv.submit(t % 4, op(op=OP_APPEND, key="k", value=f"{t},",
                            client_id=1 + t % 3, command_id=t + 1))
        kv.pump()


class _PortConfig:
    """The port's pickled EngineConfig, read back as the reference's."""

    def __setstate__(self, state):
        f = dict(state)
        f["use_pallas"] = f["pallas_interpret"] = f.pop("use_kernels")
        self.cfg = JaxConfig(**f)


_INVERSE = {
    port: ref for ref, port in convert.CHECKPOINT_CLASSES.items()
    if ref[1] != "EngineConfig"
}


class _PortToReference(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("multiraft_tpu_torch.engine.core", "EngineConfig"):
            return _PortConfig
        if module.split(".")[0] == "multiraft_tpu_torch":
            module, name = _INVERSE[(module, name)]
        return super().find_class(module, name)


def reference_restore_of_port_checkpoint(path, tmp_path):
    with open(path, "rb") as f:
        blob = _PortToReference(f).load()
    blob["cfg"] = blob["cfg"].cfg
    out = str(tmp_path / "as_reference.ckpt")
    with open(out, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
    return JaxDriver.restore(out)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_checkpoint_crosses_packages_and_continues_equal(direction, tmp_path):
    src = jax_driver(21) if direction == "reference_to_port" else port_driver(21)
    src_kv = (JaxKV if isinstance(src, JaxDriver) else BatchedKV)(
        src, record_groups=[0, 1])
    chaos(src)
    t0 = 0
    while not (src._delayed and src.payloads) and t0 < 150:
        _kv_round([(src, src_kv)], t0, t0)
        t0 += 1
    assert src._delayed and src.payloads
    path = str(tmp_path / "src.ckpt")
    src.save(path, extra=src_kv.state_dict())
    if direction == "reference_to_port":
        dst = EngineDriver.restore(path, device="cpu")
        dst_kv = BatchedKV(dst)
    else:
        dst = reference_restore_of_port_checkpoint(path, tmp_path)
        dst_kv = JaxKV(dst)
    dst_kv.load_state_dict(dst.restored_extra)
    assert dst.cfg.G == src.cfg.G and dst.cfg.membership == src.cfg.membership
    assert_same(src, dst, "restored")
    for t in range(50):
        _kv_round([(src, src_kv), (dst, dst_kv)], t0 + t, t)
        assert_same(src, dst, t)
        assert src_kv.data == dst_kv.data and src_kv.sessions == dst_kv.sessions
    assert norm(src_kv.histories) == norm(dst_kv.histories)
    assert src.commits_total > 0


def _boot_port_kv(seed=5):
    d = port_driver(seed)
    assert d.run_until_quiet_leaders(400)
    return d, BatchedKV(d, record_groups=[0, 1])


def test_batched_kv_survives_checkpoint_and_stays_linearizable(tmp_path):
    d, kv = _boot_port_kv()
    acked = {g: "" for g in range(4)}

    def append(kv, i):
        g = i % 4
        t = kv.submit(g, KVOp(op=OP_APPEND, key="k", value=f".{i}"))
        for _ in range(40):
            kv.pump()
            if t.done:
                break
        assert t.done and not t.failed
        acked[g] += f".{i}"

    for i in range(12):
        append(kv, i)
    path = str(tmp_path / "kv.ckpt")
    d.save(path, extra=kv.state_dict())
    d2 = EngineDriver.restore(path, device="cpu")
    kv2 = BatchedKV(d2)
    kv2.load_state_dict(d2.restored_extra)
    for g in range(4):
        assert kv2.get(g, "k").value == acked[g]
    for i in range(12, 24):
        append(kv2, i)
        assert kv2.get(i % 4, "k").value == acked[i % 4]
    for g in (0, 1):
        history = [
            Operation(client_id=o.client_id,
                      input=KvInput(op=o.input.op, key=o.input.key,
                                    value=o.input.value),
                      call=o.call, output=KvOutput(value=o.output.value),
                      ret=o.ret)
            for o in kv2.histories[g]
        ]
        assert len(history) >= 6
        assert_linearizable(kv_model, history, timeout=5.0, name=f"restored-{g}")


def test_restore_guards(tmp_path, monkeypatch):
    d = port_driver(3)
    d.step(5)
    path = str(tmp_path / "g.ckpt")
    d.save(path)
    blob = pickle.load(open(path, "rb"))
    for key, value, match in (("version", 999, "checkpoint version"),
                              ("mesh_devices", 4, "4-device mesh")):
        bad = str(tmp_path / f"{key}.ckpt")
        with open(bad, "wb") as f:
            pickle.dump(dict(blob, **{key: value}), f)
        with pytest.raises(ValueError, match=match):
            EngineDriver.restore(bad, device="cpu")
    # No device asked for means the card.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineDriver.restore(path)


def test_reference_class_without_counterpart_is_refused(tmp_path):
    from multiraft_tpu.utils.trace import Tracer

    ref = jax_driver(4)
    ref.step(2)
    path = str(tmp_path / "ref.ckpt")
    ref.save(path, extra={"tracer": Tracer()})
    with pytest.raises(pickle.UnpicklingError, match="utils.trace.Tracer"):
        EngineDriver.restore(path, device="cpu")


def test_save_refuses_batches_in_flight_and_replaces_atomically(tmp_path):
    d = port_driver(6)
    d.start_bulk(np.full(4, 10, np.int64))
    d.dispatch_ticks(3)
    with pytest.raises(RuntimeError, match="in flight"):
        d.save(str(tmp_path / "x.ckpt"))
    d.step(2)  # completes the batch, then steps
    path = str(tmp_path / "a.ckpt")
    d.save(path)
    assert not os.path.exists(path + ".tmp")
    saved_tick = d.tick
    d.step(5)
    # A save that fails part-way leaves the previous checkpoint whole.
    with pytest.raises((pickle.PicklingError, AttributeError, TypeError)):
        d.save(path, extra={"unpicklable": lambda: None})
    assert EngineDriver.restore(path, device="cpu").tick == saved_tick
    d.save(path)
    assert not os.path.exists(path + ".tmp")
    r = EngineDriver.restore(path, device="cpu")
    assert r.tick == d.tick and r._max_bound == d._max_bound
