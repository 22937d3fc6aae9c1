"""The port's training launcher and its checkpointer, on the CPU.

``repro_torch.launch.train.main`` in-process, as the reference's
``tests/test_launchers.py::test_train_and_restore`` runs its launcher: 10
SMOKE steps with a snapshot every 5, then a restart to 15 from the step-10
snapshot, which must resume the run (the restored parameters and moments
are the saved ones bit for bit). ``Checkpointer``'s three reference tests
(``tests/test_ft_integration.py``): atomic write and garbage collection,
durable after ``wait``, no partial files; and a bf16 state's round trip.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ft.checkpoint import Checkpointer, flatten  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def test_train_and_restore(tmp_path, capsys):
    common = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
              "--lr", "1e-3", "--ckpt-dir", str(tmp_path), "--ckpt-every",
              "5"]
    first = train.main(common + ["--steps", "10"])
    out = capsys.readouterr().out
    assert "done; snapshots: [5, 10]" in out
    assert [r["step"] for r in first] == list(range(10))
    assert all(np.isfinite(r["loss"]) for r in first)
    second = train.main(common + ["--steps", "15", "--restore"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 10" in out
    assert [r["step"] for r in second] == list(range(10, 15))
    # the restored state is the saved one: a step-10 snapshot loads into a
    # fresh model and optimizer bit for bit
    st = Checkpointer(str(tmp_path), async_write=False).restore(10)
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.train import init_opt_state
    from repro_torch.train.optimizer import TrainConfig
    lm = LM(get_config("internlm2-1.8b", smoke=True), device="cpu", seed=1)
    opt = init_opt_state(dict(lm.named_parameters()), TrainConfig())
    train.load_state(lm, opt, st)
    assert int(opt["step"]) == 10
    for key, t in flatten(train.train_state(lm, opt)).items():
        np.testing.assert_array_equal(t.detach().float().numpy(), st[key])


def test_grad_accum_flag(tmp_path, capsys):
    """``--grad-accum`` reaches the step: 4 micro-batches of the SMOKE
    batch of 8 give the first step's loss and gradient norm of the whole
    batch at once (the mean of equal micro-batches' mean losses and
    gradients), and the step that follows from the same update."""
    common = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
              "--lr", "1e-3", "--ckpt-dir", str(tmp_path), "--ckpt-every",
              "0", "--steps", "2"]
    run = train.setup(train.parse(common + ["--grad-accum", "4"]))
    assert run["tcfg"].grad_accum == 4 and run["step_fn"].tcfg.grad_accum == 4
    four = train.main(common + ["--grad-accum", "4"])
    assert "grad_accum=4" in capsys.readouterr().out
    one = train.main(common + ["--grad-accum", "1"])
    assert "grad_accum=1" in capsys.readouterr().out
    for a, b in zip(four, one):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
        assert a["lr"] == b["lr"]


def test_atomic_write_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_write=False)
    for step in (1, 2, 3):
        ck.save(step, {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 2)}})
    assert ck.available_steps() == [2, 3]      # keep=2 collected step 1
    st = ck.restore()
    assert st["_step"] == 3
    np.testing.assert_array_equal(st["a"], np.arange(4.0))
    np.testing.assert_array_equal(st["b/c"], np.ones((2, 2)))
    assert os.path.exists(os.path.join(str(tmp_path), "manifest.json"))


def test_async_write_durable_after_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=True)
    ck.save(7, {"x": torch.zeros(1024, 64)})
    ck.wait()
    assert ck.available_steps() == [7]


def test_no_partial_files_visible(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, {"x": torch.zeros(8)})
    assert not [f for f in os.listdir(str(tmp_path)) if f.endswith(".tmp")]


def test_bf16_state_round_trip_and_corrupt_skip(tmp_path):
    """bf16 tensors are stored widened to f32 (exact) and recorded as bf16
    in the manifest; a truncated newest snapshot is skipped for the one
    before it."""
    import json
    ck = Checkpointer(str(tmp_path), async_write=False)
    w = torch.randn(3, 5).to(torch.bfloat16)
    ck.save(1, {"w": w, "step": torch.tensor(4, dtype=torch.int32)})
    ck.save(2, {"w": w, "step": torch.tensor(5, dtype=torch.int32)})
    with open(os.path.join(str(tmp_path), "manifest.json")) as fh:
        assert json.load(fh)["keys"]["w"] == [[3, 5], "bfloat16"]
    with open(ck._path(2), "wb") as fh:
        fh.write(b"truncated")
    st = ck.restore()
    assert st["_step"] == 1 and int(st["step"]) == 4
    assert torch.equal(torch.from_numpy(st["w"]).to(torch.bfloat16), w)
    with pytest.raises(Exception):
        ck.restore(2)
