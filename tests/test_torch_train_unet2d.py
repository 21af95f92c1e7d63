"""icl_tpu_torch's U-Net-ICL 2D training path against the JAX package's:
one ICL train step (metrics, gradients, new parameters, BatchNorm stats)
with and without the fused `sspa` pair; the `Prefetcher` (the same
batches as the plain stream, a worker's exception raised again, the
thread stopped); the trainer's scalars (the JAX trainer's tags, the
values `fit` returns); the U-Net CLI's refusals and its need of a card;
and a tiny training run through that CLI on the CPU whose stripped best
checkpoint reproduces the validation dice through the eval CLI at its
default model.

Small size as `test_torch_unet2d.py`: the default U-Net features, patch
64, 4 classes, batch 4 with 2 labeled, `zero_stochastic` on both sides.
The step runs in f64 on both sides (`test_icl_step_matches_jax` says
why), the CLI run in f32. Tolerances as `test_torch_train2d.py`: metrics
1e-4 relative; each gradient and each parameter update within 1e-3 of
its largest magnitude plus 1e-6; running means 1e-5 absolute; running
variances 1e-5 absolute after the n / (n - 1) factor; batches equal; the
eval CLI's mean dice equal to the trainer's.
"""
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu import losses as jax_losses
from icl_tpu.data.synth import make_synthetic_acdc
from icl_tpu.models import layers as jax_layers
from icl_tpu.train.optim import make_sgd
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_icl_step as jax_make_icl_step

from icl_tpu_torch.data.pipeline import Prefetcher, acdc_train_batches
from icl_tpu_torch.data.synth import synthetic_acdc
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import METRIC_KEYS, make_icl_step
from icl_tpu_torch.utils.convert import icl_unet2d_state_dict_from_jax
from test_torch_train import _assert_close_to_scale, _capture_grads
from test_torch_unet2d import (LABELED_BS, NCLS, PATCH, assert_running_stats, bn_batch_sizes,
                               images, jax_variables)
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

BASE_LR, MAX_IT, CONSIS = 0.01, 10, 50.0


def _exact_align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """`icl_tpu.models.layers._align_corners_matrix` with its weights kept
    in f64 (the JAX package rounds them to f32)."""
    if n_in == 1 or n_out == 1:
        m = np.zeros((n_out, n_in))
        m[:, 0] = 1.0
        return m
    s = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    j0 = np.floor(s).astype(np.int64)
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), j0), 1.0 - (s - j0))
    np.add.at(m, (np.arange(n_out), np.minimum(j0 + 1, n_in - 1)), s - j0)
    return m


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def jax_step():
    """One JAX ICL step (the two sspa calls) in f64: (batch, old, grads,
    new, metrics), the state dicts in the port's layout. Its fused pair is
    the same step (`tests/test_icl_pair_fusion.py`), so it is the
    reference of both port steps."""
    jax_model, params, bs = jax_variables(5)
    x, xt = images(6)
    y = np.random.default_rng(7).integers(0, NCLS, (2 * LABELED_BS, PATCH, PATCH)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "_align_corners_matrix", _exact_align_corners_matrix)
        mp.setattr(jax_losses, "_resize_maps", lambda fm, spatial: jax.image.resize(
            fm, (fm.shape[0], *spatial, fm.shape[-1]), method="linear"))
        mp.setattr(jax_losses, "one_hot",
                   lambda labels, n: jax.nn.one_hot(labels, n, dtype=jnp.float64))
        params, bs = _f64(params), _f64(bs)
        tx = optax.chain(_capture_grads(), make_sgd(BASE_LR, MAX_IT))
        step = jax_make_icl_step(jax_model, tx, NCLS, LABELED_BS, (PATCH, PATCH), CONSIS)
        new_state, metrics = jax.jit(step)(TrainState.create(params, bs, tx),
                                           {"image": jnp.asarray(x, jnp.float64),
                                            "label": jnp.asarray(y)}, jax.random.PRNGKey(0))
        new_state, metrics = jax.device_get((new_state, metrics))
    assert np.asarray(metrics["loss"]).dtype == np.float64
    new_bs = new_state.batch_stats
    return ({"image": torch.from_numpy(xt).double(), "label": torch.from_numpy(y).long()},
            icl_unet2d_state_dict_from_jax(params, bs),
            icl_unet2d_state_dict_from_jax(new_state.opt_state[0], new_bs),
            icl_unet2d_state_dict_from_jax(new_state.params, new_bs),
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("fuse", [False, True], ids=["two_calls", "fused_pair"])
def test_icl_step_matches_jax(jax_step, fuse):
    """In f64: in f32 the gradients of the layers that feed a train-mode
    BatchNorm cancel, so f32 rounding alone, and the JAX package's f32
    upsampling weights (computed exactly in torch), move them past the
    tolerance there."""
    batch, old, grads, new, met_j = jax_step
    model = net_factory("icl_unet", 1, NCLS, device="cpu", patch_size=PATCH, fuse_sspa_pair=fuse,
                        zero_stochastic=True)
    model.load_state_dict(old, strict=True)
    model = model.double().train()
    sizes = bn_batch_sizes(model)
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    met_p = make_icl_step(model, opt, NCLS, LABELED_BS, (PATCH, PATCH), CONSIS)(batch)

    for k in METRIC_KEYS:
        assert met_p[k].dtype == torch.float64
        np.testing.assert_allclose(float(met_p[k]), met_j[k], rtol=1e-4, err_msg=k)
    for name, p in model.named_parameters():
        _assert_close_to_scale(p.grad, grads[name], f"grad {name}")
        _assert_close_to_scale(p.detach() - old[name], new[name] - old[name], f"update {name}")
    assert_running_stats(model, sizes, old, new)


def _slices():
    slices, _ = synthetic_acdc(12, 0, 40, 1, NCLS, seed=1)
    return slices


def test_prefetcher_yields_the_stream_and_raises_the_workers_error():
    kw = dict(labeled_count=5, batch_size=4, labeled_bs=2, patch_size=(48, 32), seed=3)
    want = acdc_train_batches(_slices(), **kw)
    with Prefetcher(acdc_train_batches(_slices(), **kw)) as got:
        for _ in range(5):
            g, w = next(got), next(want)
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])
    assert not got._thread.is_alive()

    def failing():
        yield {"image": np.zeros(1)}
        yield {"image": np.ones(1)}
        raise ValueError("no more slices")

    stream = Prefetcher(failing())
    assert [float(b["image"][0]) for b in (next(stream), next(stream))] == [0.0, 1.0]
    with pytest.raises(ValueError, match="no more slices"):
        next(stream)
    assert list(Prefetcher(iter([{"a": 1}]))) == [{"a": 1}]


def test_cli_refuses_unported_flags_and_needs_cuda(monkeypatch):
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_inherent_consistent_unet_2D as cli

    for flags in (["--dist_coordinator", "host0:1234"], ["--num_processes", "2"],
                  ["--process_id", "0"], ["--input_mode", "hbm"], ["--state_dtype", "float16"]):
        with pytest.raises(SystemExit):
            cli.parse_args(flags)
    args = cli.parse_args([])
    assert (args.input_mode, args.state_dtype, args.scan_steps, args.dispatch_depth) == (
        "host", "float32", 1, 1)
    args = cli.parse_args(["--input_mode", "device_bank", "--state_dtype", "bfloat16",
                           "--scan_steps", "8", "--dispatch_depth", "2"])
    assert (args.input_mode, args.state_dtype, args.scan_steps, args.dispatch_depth) == (
        "device_bank", "bfloat16", 8, 2)
    assert cli.parse_args([]).checkpoint_interval == 0
    assert cli.parse_args(["--checkpoint_interval", "100"]).checkpoint_interval == 100
    args = cli.parse_args(["--fuse_icl_pair", "--input_mode", "host", "--scan_steps", "1"])
    assert args.fuse_icl_pair and args.model == "icl_unet" and args.patch_size == [256, 256]
    assert (args.batch_size, args.labeled_bs, args.base_lr, args.device) == (16, 8, 0.01, "cuda")
    eval_args = test_2D_ACDC.parse_args([])
    assert eval_args.model == "icl_unet" and eval_args.patch_size == [256, 256]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--root_path", "unused"])


def test_cli_trains_on_cpu_writes_scalars_and_eval_cli_reproduces_val_dice(tmp_path, monkeypatch):
    """Two steps of U-Net-ICL at 64^2 with the fused pair, batch 4 (2
    labeled), f32, validation at step 2 on two 3-slice volumes; the
    scalars carry the JAX trainer's tags with the values `fit` returned;
    the stripped best checkpoint then loads strictly into UNet through the
    eval CLI at its default model and gives the same mean dice, exactly."""
    pytest.importorskip("h5py")
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_inherent_consistent_unet_2D as cli

    root = tmp_path / "ACDC"
    make_synthetic_acdc(str(root), num_slices=72, num_volumes=2, slice_size=40, vol_depth=3, seed=0)
    monkeypatch.chdir(root)  # snapshots land in ../experiments
    common = ["--root_path", str(root), "--exp", "ACDC/ICL", "--labeled_num", "3",
              "--num_tries", "t", "--patch_size", "64", "64", "--device", "cpu"]
    result = cli.main(common + ["--max_iterations", "2", "--val_interval", "2", "--batch_size", "4",
                                "--labeled_bs", "2", "--seed", "3", "--fuse_icl_pair"])
    assert [r["iteration"] for r in result["log"]] == [1, 2]
    assert all(np.isfinite(r[k]) for r in result["log"] for k in METRIC_KEYS)
    assert result["best_mean_dice"] > 0 and result["best_path"] is not None
    snapshot = tmp_path / "experiments" / "ACDC" / "ICL_3_labeled" / "icl_unet_exp_t"
    assert (snapshot / "log.txt").exists() and (snapshot / "model" / "model_best.pth").exists()

    rows = [json.loads(line) for line in open(snapshot / "log" / "scalars.jsonl")]
    got = {(r["tag"], r["step"]): r["value"] for r in rows}
    assert len(got) == len(rows)
    want = {}
    for r in result["log"]:
        want[("Info/lr", r["iteration"])] = r["lr"]
        want.update({(f"Loss/{k}", r["iteration"]): r[k] for k in METRIC_KEYS})
    val = result["vals"][-1]
    for k in ("mean_dice", "mean_hd95"):
        want[(f"metric_all/{k}", 2)] = val[k]
    assert set(got) == set(want) | {("metric_all/std_dice", 2), ("metric_all/std_hd95", 2)} | {
        (f"metric_class_{c}/mean_{m}", 2) for c in ("RV", "Myo", "LV") for m in ("dice", "hd95")}
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12, abs=0), key

    total = test_2D_ACDC.main(common)
    assert total[0] == val["mean_dice"]
