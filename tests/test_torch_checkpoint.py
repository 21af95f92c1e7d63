"""icl_tpu_torch's resumable train state: the save/load round trip (model
with its BatchNorm buffers, SGD momentum, update count, iteration, and
the CPU and module generators) bit for bit; the rolling step files
against the JAX package's `save_train_state_rolling` (the same step
files kept for keep 2 and keep 0, a negative keep refused, `state_last`
the newest step); `AsyncStateSaver` writing the values of the moment it
was called; `fit` writing the rolling and the final files; and a resume:
4 steps equal 2 steps + `restore_state` + 2 steps bit for bit on the CPU,
dropout and drop path on.

Small size: the U-Net-ICL of `test_torch_train_unet2d.py` (patch 64, 4
classes, batch 4 with 2 labeled) for the resume, the plain U-Net at 32^2
for the rest. Every comparison is exact.
"""
import os

import numpy as np
import pytest
import torch

from icl_tpu.utils import checkpoint as jax_ckpt

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.pipeline import acdc_train_batches
from icl_tpu_torch.data.synth import synthetic_acdc
from icl_tpu_torch.models.layers import Dropout
from icl_tpu_torch.train.trainer import Trainer
from icl_tpu_torch.utils import checkpoint as ckpt

NCLS = 4


def _config(tmp_path, model="unet", side=32, steps=4, tries="t", **kw):
    return ExperimentConfig(root_path="in-memory", exp="ACDC/ckpt", model=model, num_classes=NCLS,
                            max_iterations=steps, batch_size=4, labeled_bs=2, base_lr=0.01,
                            patch_size=(side, side), seed=3, labeled_num=3, num_tries=tries,
                            val_interval=0, experiments_dir=str(tmp_path), **kw)


def _batches(side, n, seed=3):
    slices, _ = synthetic_acdc(12, 0, 40, 1, NCLS, seed=1)
    stream = acdc_train_batches(slices, 6, 4, 2, (side, side), seed=seed)
    return [next(stream) for _ in range(n)]


def _assert_states_equal(a: dict, b: dict, where: str = "") -> None:
    assert type(a) is type(b), where
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_states_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_states_equal(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def _with_module_generators(trainer: Trainer) -> Trainer:
    """Give every dropout of the model a generator of its own."""
    for i, m in enumerate(m for m in trainer.model.modules() if isinstance(m, Dropout)):
        m.generator = torch.Generator().manual_seed(100 + i)
    return trainer


def test_save_load_round_trip_bit_for_bit(tmp_path):
    cfg = _config(tmp_path)
    torch.manual_seed(0)
    a = _with_module_generators(Trainer(cfg, device="cpu"))
    a.fit(_batches(32, 2))  # momentum, count, BatchNorm stats and generators all moved
    state = a.train_state()
    assert state["iteration"] == state["count"] == 2 and state["optimizer"]["state"]
    n_dropouts = sum(isinstance(m, Dropout) for m in a.model.modules())
    assert set(state["rng"]) == {"cpu", "modules"} and len(state["rng"]["modules"]) == n_dropouts
    assert any(k.endswith("num_batches_tracked") for k in state["model"])
    path = ckpt.save_train_state(cfg.snapshot_path, state, "round")
    assert path == os.path.join(cfg.snapshot_path, "model", "state_round.pt")

    torch.manual_seed(1)
    b = _with_module_generators(Trainer(cfg, device="cpu"))
    b.load_train_state(ckpt.load_train_state(cfg.snapshot_path, "round", "cpu"))
    _assert_states_equal(b.train_state(), state)
    assert torch.equal(torch.get_rng_state(), state["rng"]["cpu"])


def test_rolling_files_follow_the_jax_rule(tmp_path):
    """The same steps saved with keep 2 and keep 0 leave the same step
    files in both packages; `state_last` is the newest step's bytes."""
    state = {"w": torch.arange(6.0), "iteration": 0}
    for keep in (2, 0):
        port, jax_dir = str(tmp_path / f"port{keep}"), str(tmp_path / f"jax{keep}")
        for step in (3, 6, 9, 12):
            state["iteration"] = step
            path = ckpt.save_train_state_rolling(port, state, step, keep=keep)
            jax_ckpt.save_train_state_rolling(jax_dir, {"w": np.arange(6.0)}, step, keep=keep)
            last = ckpt.load_train_state(port, "last")
            assert last["iteration"] == step and path.endswith(f"state_step_{step:08d}.pt")
        got = [ckpt._checkpoint_step_of(p) for p in ckpt.list_step_checkpoints(port)]
        want = [jax_ckpt._checkpoint_step_of(p) for p in jax_ckpt.list_step_checkpoints(jax_dir)]
        assert got == want == ([9, 12] if keep == 2 else [3, 6, 9, 12])
        assert ckpt.latest_checkpoint_step(port) == jax_ckpt.latest_checkpoint_step(jax_dir) == 12
        with open(os.path.join(port, "model", "state_last.pt"), "rb") as f, \
                open(os.path.join(port, "model", "state_step_00000012.pt"), "rb") as g:
            assert f.read() == g.read()
    assert ckpt.latest_checkpoint_step(str(tmp_path / "none")) == -1
    for save in (ckpt.save_train_state_rolling, jax_ckpt.save_train_state_rolling):
        with pytest.raises(ValueError, match="keep"):
            save(str(tmp_path / "neg"), {"w": np.zeros(1)}, 1, keep=-1)
    # the final save replaces state_last without writing through its link
    ckpt.save_train_state(str(tmp_path / "port2"), {"w": torch.zeros(1), "iteration": 13})
    assert ckpt.load_train_state(str(tmp_path / "port2"), "step_00000012")["iteration"] == 12


def test_async_saver_writes_the_state_of_the_call(tmp_path):
    model = torch.nn.Linear(4, 3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with ckpt.AsyncStateSaver() as saver:
        path = saver.save(str(tmp_path), {"model": model.state_dict(), "iteration": 7}, "async")
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)  # a step taken after save returned
    got = torch.load(path, weights_only=True)
    assert got["iteration"] == 7
    for k, v in before.items():
        assert torch.equal(got["model"][k], v), k
        assert not torch.equal(model.state_dict()[k], v)


def test_fit_writes_rolling_and_final_states(tmp_path):
    cfg = _config(tmp_path, steps=3, checkpoint_interval=1, keep_checkpoints=2)
    trainer = Trainer(cfg, device="cpu")
    result = trainer.fit(_batches(32, 3))
    assert [(s["iteration"], os.path.basename(s["path"])) for s in result["saves"]] == [
        (1, "state_step_00000001.pt"), (2, "state_step_00000002.pt"),
        (3, "state_step_00000003.pt"), (3, "state_last.pt")]
    assert all(s["bytes"] > 0 and s["seconds"] >= 0 for s in result["saves"])
    assert [os.path.basename(p) for p in ckpt.list_step_checkpoints(cfg.snapshot_path)] == [
        "state_step_00000002.pt", "state_step_00000003.pt"]
    last = ckpt.load_train_state(cfg.snapshot_path)
    assert last["iteration"] == last["count"] == 3
    _assert_states_equal(last["model"], trainer.model.state_dict())


def test_four_steps_equal_two_restore_two_bit_for_bit(tmp_path):
    """U-Net-ICL at 64^2 with dropout and drop path drawn from torch's CPU
    generator: run A takes 4 steps; run B takes 2 with checkpoint_interval
    2, then a fresh Trainer restores `state_last` and takes A's batches 3
    and 4. Parameters, buffers, momentum, count, iteration and the
    generator's state all end equal bit for bit."""
    batches = _batches(64, 4)
    torch.manual_seed(0)
    a = Trainer(_config(tmp_path, "icl_unet", 64, tries="a"), device="cpu")
    a.fit(batches)

    cfg_b = _config(tmp_path, "icl_unet", 64, tries="b", checkpoint_interval=2)
    torch.manual_seed(0)
    first = Trainer(cfg_b, device="cpu")
    first.fit(batches[:2])
    saved = first.train_state()
    assert saved["iteration"] == 2
    del first
    torch.manual_seed(123)  # the restore must bring back the generator's state
    b = Trainer(cfg_b, device="cpu")
    assert b.restore_state() == 2
    _assert_states_equal(b.train_state(), saved, "restored")
    result = b.fit(batches[2:])
    assert [r["iteration"] for r in result["log"]] == [3, 4]
    _assert_states_equal(b.train_state(), a.train_state(), "after step 4")
