"""icl_tpu_torch's step groups and dispatch window (`--scan_steps`,
`--dispatch_depth`) against one step at a time, on the CPU, as the JAX
package's `tests/test_train_smoke.py:168-330` holds its scan and
dispatch depth: `fit` with scan_steps 4 and 3 against 1, bit for bit,
with groups cut at the validation and checkpoint boundaries that K does
not divide; dispatch_depth 3 against 1, parameters bit for bit and
log.txt's loss lines equal; the device-bank fit with scan_steps 3 against
1; and the flagship CLI's fast flags on the CPU, its bf16 best checkpoint
reproducing the trainer's validation dice through the eval CLI. On the
CPU a group runs its steps eagerly (the card replays a captured CUDA
graph: `chip_smoke.py` phases 38-39, `tests/test_torch_sgd_bf16_card.py`).
"""
import os

import numpy as np
import pytest
import torch

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.train.trainer import Trainer
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(4, 1, 16, 16)).astype(np.float32),
             "label": rng.integers(0, 4, (4, 16, 16))} for _ in range(n)]


def _evaluate(model):
    return {"mean_dice": 0.5, "mean_hd95": 1.0, "std_dice": 0.0, "std_hd95": 0.0,
            "class_mean": [(0.5, 1.0)] * 3}


def _fit(tmp_path, tries, batches, evaluate=None, **kw):
    """A fresh supervised U-Net (16^2, batch 4) from seed 0 through `fit`:
    (trainer, result, the group sizes it ran, log.txt's loss lines)."""
    cfg = ExperimentConfig(root_path="in-memory", exp="dispatch", model="unet", num_classes=4,
                           batch_size=4, patch_size=(16, 16), labeled_num=7, num_tries=tries,
                           experiments_dir=str(tmp_path), **kw)
    torch.manual_seed(0)
    trainer = Trainer(cfg, device="cpu")
    groups = []
    to_host = trainer._to_host
    trainer._to_host = lambda base, vecs: groups.append(len(vecs)) or to_host(base, vecs)
    result = trainer.fit(iter(batches), evaluate=evaluate)
    with open(os.path.join(cfg.snapshot_path, "log.txt")) as f:
        lines = [line.split("]", 1)[-1] for line in f if "iteration" in line and "loss" in line]
    return trainer, result, groups, lines


def _assert_same_state(a: Trainer, b: Trainer):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    for x, y in zip(a.optimizer.momentum_buffers, b.optimizer.momentum_buffers):
        assert torch.equal(x, y)
    assert (a.iteration, a.optimizer.count) == (b.iteration, b.optimizer.count)


@pytest.mark.parametrize("k,groups", [(4, [4, 1, 3, 1]), (3, [3, 1, 1, 3, 1])])
def test_scan_steps_match_one_step_at_a_time(tmp_path, k, groups):
    """9 steps, a validation every 5 and a checkpoint every 4: the groups
    never cross either, so with K = 4 they are 4, 1, 3, 1 and with K = 3
    3, 1, 1, 3, 1 (the JAX package's rule)."""
    batches = _batches(9)
    kw = dict(max_iterations=9, val_interval=5, checkpoint_interval=4, keep_checkpoints=0)
    one, res1, groups1, log1 = _fit(tmp_path, "k1", batches, _evaluate, **kw)
    many, res_k, groups_k, log_k = _fit(tmp_path, f"k{k}", batches, _evaluate, scan_steps=k, **kw)
    assert groups1 == [1] * 9 and groups_k == groups
    _assert_same_state(one, many)
    assert log_k == log1 and len(log1) == 9
    assert [v["iteration"] for v in res_k["vals"]] == [5]
    assert [s["iteration"] for s in res_k["saves"]] == [4, 8, 9]
    assert [r["iteration"] for r in res_k["log"]] == list(range(1, 10))


def test_dispatch_depth_matches_depth_one(tmp_path):
    """8 steps in groups of 2 at depth 3 against depth 1, a validation at
    step 6: the parameters bit for bit and the loss lines of log.txt equal
    and in order (the window drains before the validation and at the end)."""
    batches = _batches(8, seed=2)
    kw = dict(max_iterations=8, val_interval=6, scan_steps=2)
    one, res1, _, log1 = _fit(tmp_path, "d1", batches, _evaluate, **kw)
    deep, res3, _, log3 = _fit(tmp_path, "d3", batches, _evaluate, dispatch_depth=3, **kw)
    _assert_same_state(one, deep)
    assert log3 == log1 and len(log1) == 8
    assert [r["iteration"] for r in res3["log"]] == list(range(1, 9))
    assert [(r["iteration"], r["loss"]) for r in res3["log"]] == [
        (r["iteration"], r["loss"]) for r in res1["log"]]


def test_device_bank_fit_scan_3_matches_1(tmp_path):
    """The device-augment step on a bank (its draws with each batch): 6
    steps in groups of 3 against one at a time, bit for bit."""
    from icl_tpu_torch.data.device_bank import bank_batches, build_acdc_bank, supervised_index_batches
    from icl_tpu_torch.data.synth import synthetic_acdc

    slices, _ = synthetic_acdc(10, 0, 20, 1, 4, seed=3)
    image_bank, label_bank = build_acdc_bank(slices, 16, "cpu")
    stream = bank_batches(image_bank, label_bank, supervised_index_batches(10, 4, seed=3), seed=3)
    batches = [next(stream) for _ in range(6)]
    kw = dict(max_iterations=6, val_interval=0, device_augment=True)
    one, _, _, log1 = _fit(tmp_path, "b1", batches, **kw)
    many, _, groups, log3 = _fit(tmp_path, "b3", batches, scan_steps=3, **kw)
    assert groups == [3, 3]
    _assert_same_state(one, many)
    assert log3 == log1


def test_flagship_cli_fast_flags_on_cpu_and_eval_cli_reproduces_val_dice(tmp_path, monkeypatch):
    """The flagship CLI with `--state_dtype bfloat16 --input_mode device_bank
    --scan_steps 2 --dispatch_depth 2 --fuse_icl_pair` at 32^2, batch 4 (2
    labeled), 3 steps, a validation at step 3 (on the bf16 weights in f32)
    and a checkpoint at step 2; the stripped best checkpoint (bf16) then
    gives the same mean dice through the eval CLI, exactly."""
    pytest.importorskip("h5py")
    from icl_tpu.data.synth import make_synthetic_acdc

    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_inherent_consistent_unet_2D as cli
    from icl_tpu_torch.train.steps import METRIC_KEYS

    root = tmp_path / "ACDC"
    make_synthetic_acdc(str(root), num_slices=72, num_volumes=2, slice_size=40, vol_depth=3, seed=0)
    monkeypatch.chdir(root)
    common = ["--root_path", str(root), "--exp", "ACDC/Fast", "--labeled_num", "3", "--num_tries",
              "t", "--patch_size", "32", "32", "--device", "cpu"]
    torch.manual_seed(0)
    result = cli.main(common + ["--max_iterations", "3", "--val_interval", "3", "--batch_size", "4",
                                "--labeled_bs", "2", "--checkpoint_interval", "2",
                                "--fuse_icl_pair", "--precision", "bfloat16", "--state_dtype",
                                "bfloat16", "--input_mode", "device_bank", "--scan_steps", "2",
                                "--dispatch_depth", "2"])
    assert [r["iteration"] for r in result["log"]] == [1, 2, 3]
    assert all(np.isfinite(r[k]) for r in result["log"] for k in METRIC_KEYS)
    assert [s["iteration"] for s in result["saves"]] == [2, 3]
    val = result["vals"][-1]["mean_dice"]
    assert val > 0 and result["best_path"] is not None
    best = torch.load(result["best_path"], weights_only=True)
    assert any(v.dtype == torch.bfloat16 for v in best.values())
    assert test_2D_ACDC.main(common)[0] == val


def test_raw_slices_and_the_bank_give_the_same_steps(tmp_path):
    """The device-augment step's two input forms: raw slices ("image",
    "label", as `acdc_raw_batches` makes them) and the bank with indices,
    for the same slices and draws, train to the same parameters bit for
    bit (groups of 2)."""
    from icl_tpu_torch.data.device_bank import bank_batches, build_acdc_bank, supervised_index_batches
    from icl_tpu_torch.data.synth import synthetic_acdc

    slices, _ = synthetic_acdc(10, 0, 20, 1, 4, seed=4)
    image_bank, label_bank = build_acdc_bank(slices, 16, "cpu")
    stream = bank_batches(image_bank, label_bank, supervised_index_batches(10, 4, seed=4), seed=4)
    bank = [next(stream) for _ in range(4)]
    raw = [{"image": image_bank[b["indices"]].numpy(), "label": label_bank[b["indices"]].numpy(),
            "augment": b["augment"]} for b in bank]
    kw = dict(max_iterations=4, val_interval=0, device_augment=True, scan_steps=2)
    from_bank, _, _, log_bank = _fit(tmp_path, "bank", bank, **kw)
    from_raw, _, _, log_raw = _fit(tmp_path, "raw", raw, **kw)
    _assert_same_state(from_bank, from_raw)
    assert log_raw == log_bank
