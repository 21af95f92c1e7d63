"""icl_tpu_torch's 3D U-Net training paths against the JAX package's: one
ICL step of U-Net-ICL 3D and one supervised step of U-Net 3D (metrics,
gradients, new parameters, the heads' BatchNorm running stats), the
supervised BraTS batches, the recompute (remat on equals remat off with
dropout on, whatever generator the dropouts draw from), the CLIs'
refusals and their need of a card, and tiny training runs through the
BraTS CLIs on the CPU whose best checkpoints reproduce the validation
dice through `test_3D_BraTS`.

Small size as `test_torch_unet3d.py`: 2 classes, batch 4 with 2
labeled, dropout and drop path off on both sides for the steps, which run
at patch 16^3 (ICL scales 1^3, 2^3, 4^3; the JAX f64 convs are slow on
the CPU) while the recompute and the CLIs run at 32^3. The steps run in
f64 on both sides (JAX under `jax.enable_x64`, its loss
maps and one-hot kept in f64 by monkeypatch): in f32 the gradients of
the layers that feed a normalisation cancel (every backbone conv feeds
an InstanceNorm, `mlp2` and the attention convs feed the heads'
train-mode BatchNorms), so f32 rounding alone moves them past the
tolerance (`test_icl_step_matches_jax` measures it). Tolerances as
`test_torch_train.py`: metrics 1e-4 relative; each gradient and each
parameter update within 1e-3 of its largest magnitude plus 1e-6;
running means 1e-5 absolute; running variances 1e-5 absolute after the
n / (n - 1) factor; batches equal; the eval CLI's mean dice equal to the
trainer's. Remat on and off: equal bit for bit.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu import losses as jax_losses
from icl_tpu.data.brats import brats_supervised_batches as jax_brats_supervised_batches
from icl_tpu.data.synth import make_synthetic_brats
from icl_tpu.models.unet3d import UNet3D as JaxUNet3D
from icl_tpu.train.optim import make_sgd
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_icl_step as jax_make_icl_step
from icl_tpu.train.steps import make_supervised_step as jax_make_supervised_step

from icl_tpu_torch.data.brats import brats_supervised_batches
from icl_tpu_torch.data.synth import synthetic_brats_cases
from icl_tpu_torch.models.layers import Dropout
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import (METRIC_KEYS, SUPERVISED_METRIC_KEYS, make_icl_step,
                                       make_supervised_step)
from icl_tpu_torch.utils.convert import icl_unet3d_state_dict_from_jax, unet3d_state_dict_from_jax
from test_torch_train import _assert_close_to_scale, _capture_grads
from test_torch_unet2d import assert_running_stats, bn_batch_sizes
from test_torch_unet3d import (LABELED_BS, NCLS, PATCH, images, jax_variables,  # noqa: F401
                               no_stochastic_jax)
from _torch_dp import assert_takes_multi_process_flags
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

BASE_LR, MAX_IT, CONSIS, SEG_WEIGHT = 0.01, 10, 10.0, 0.5
STEP_PATCH = 16


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _labels(seed: int, patch: int, n: int = 2 * LABELED_BS) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, NCLS, (n,) + (patch,) * 3).astype(np.int32)


def _jax_step(make_step, params, bs, x, y, dtype):
    """One jitted JAX step from (params, batch_stats) on (x, y) in `dtype`,
    its loss maps and one-hot kept in that dtype: (grads, new state,
    metrics) on the host."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(dtype == np.float64):
        mp.setattr(jax_losses, "_resize_maps", lambda fm, spatial: jax.image.resize(
            fm, (fm.shape[0], *spatial, fm.shape[-1]), method="linear"))
        mp.setattr(jax_losses, "one_hot", lambda labels, n: jax.nn.one_hot(labels, n, dtype=dtype))
        cast = (lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), t))
        tx = optax.chain(_capture_grads(), make_sgd(BASE_LR, MAX_IT))
        state = TrainState.create(cast(params), cast(bs), tx)
        new_state, metrics = jax.jit(make_step(tx))(
            state, {"image": jnp.asarray(x, dtype), "label": jnp.asarray(y)}, jax.random.PRNGKey(0))
        new_state, metrics = jax.device_get((new_state, metrics))
    assert np.asarray(metrics["loss"]).dtype == dtype
    return new_state.opt_state[0], new_state, {k: float(v) for k, v in metrics.items()}


def _assert_step(model, old, grads, new, met_p, met_j, keys):
    for k in keys:
        np.testing.assert_allclose(float(met_p[k]), met_j[k], rtol=1e-4, err_msg=k)
    for name, p in model.named_parameters():
        _assert_close_to_scale(p.grad, grads[name], f"grad {name}")
        _assert_close_to_scale(p.detach() - old[name], new[name] - old[name], f"update {name}")


@pytest.mark.parametrize("fuse", [False, True], ids=["two_calls", "fused_pair"])
def test_icl_step_matches_jax(fuse, no_stochastic_jax):
    """In f64 (the module docstring says why)."""
    jax_model, params, bs = jax_variables(5, patch=STEP_PATCH)
    x, xt = images(6, patch=STEP_PATCH)
    y = _labels(7, STEP_PATCH)
    grads, new_state, met_j = _jax_step(
        lambda tx: jax_make_icl_step(jax_model, tx, NCLS, LABELED_BS, (STEP_PATCH,) * 3, CONSIS),
        params, bs, x, y, np.float64)
    old = icl_unet3d_state_dict_from_jax(_f64(params), _f64(bs))
    model = net_factory("unet_3D_icl", 1, NCLS, device="cpu", patch_size=STEP_PATCH,
                        fuse_sspa_pair=fuse, zero_stochastic=True)
    model.load_state_dict(old, strict=True)
    model = model.double().train()
    sizes = bn_batch_sizes(model)
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    met_p = make_icl_step(model, opt, NCLS, LABELED_BS, (STEP_PATCH,) * 3, CONSIS)(
        {"image": torch.from_numpy(xt).double(), "label": torch.from_numpy(y).long()})
    assert set(met_p) == set(met_j) == set(METRIC_KEYS)
    assert all(v.dtype == torch.float64 for v in met_p.values())
    new_bs = new_state.batch_stats
    _assert_step(model, old, icl_unet3d_state_dict_from_jax(grads, new_bs),
                 icl_unet3d_state_dict_from_jax(new_state.params, new_bs), met_p, met_j, METRIC_KEYS)
    assert_running_stats(model, sizes, old, icl_unet3d_state_dict_from_jax(new_state.params, new_bs))


def test_supervised_step_matches_jax(no_stochastic_jax):
    """seg_weight 0.5 (the AMOS supervised CLI's), in f64 as the ICL step."""
    _, params, _ = jax_variables(8, patch=STEP_PATCH)
    params = params["backbone"]
    x, xt = images(9, patch=STEP_PATCH)
    y = _labels(10, STEP_PATCH)
    grads, new_state, met_j = _jax_step(
        lambda tx: jax_make_supervised_step(JaxUNet3D(1, NCLS), tx, NCLS, seg_weight=SEG_WEIGHT),
        params, {}, x, y, np.float64)
    old = unet3d_state_dict_from_jax(_f64(params))
    model = net_factory("unet_3D", 1, NCLS, device="cpu", zero_stochastic=True)
    model.load_state_dict(old, strict=True)
    model = model.double().train()
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    met_p = make_supervised_step(model, opt, NCLS, SEG_WEIGHT)(
        {"image": torch.from_numpy(xt).double(), "label": torch.from_numpy(y).long()})
    assert set(met_p) == set(met_j) == set(SUPERVISED_METRIC_KEYS)
    _assert_step(model, old, unet3d_state_dict_from_jax(grads),
                 unet3d_state_dict_from_jax(new_state.params), met_p, met_j, SUPERVISED_METRIC_KEYS)


@pytest.mark.parametrize("generator", [False, True], ids=["default_rng", "own_generators"])
def test_remat_equals_no_remat_with_dropout_on(generator):
    """One f32 ICL step of U-Net-ICL 3D with dropout (0.3) and drop path
    on, from the same weights and RNG states, with and without the
    recompute: the same loss terms, gradients and new parameters, bit for
    bit. With `generator` the dropouts draw from generators of their own,
    which torch.utils.checkpoint does not restore."""
    x = torch.from_numpy(images(11)[1])
    y = torch.from_numpy(_labels(12, PATCH)).long()

    def step(remat: bool):
        model = net_factory("unet_3D_icl", 1, NCLS, device="cpu", patch_size=PATCH, remat=remat,
                            generator=torch.Generator().manual_seed(3))
        drops = [m for m in model.modules() if isinstance(m, Dropout)]
        assert [m.p for m in drops] == [0.3, 0.3]
        for i, m in enumerate(drops):
            m.generator = torch.Generator().manual_seed(20 + i) if generator else None
        torch.manual_seed(4)
        opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
        metrics = make_icl_step(model, opt, NCLS, LABELED_BS, (PATCH,) * 3, CONSIS)(
            {"image": x, "label": y})
        return metrics, {n: (p.grad, p.detach()) for n, p in model.named_parameters()}

    (met_off, off), (met_on, on) = step(False), step(True)
    for k in METRIC_KEYS:
        assert torch.equal(met_on[k], met_off[k]), k
    for n, (grad, param) in off.items():
        assert torch.equal(on[n][0], grad), f"grad {n}"
        assert torch.equal(on[n][1], param), n
    # the dropouts did drop: without them the step differs
    model = net_factory("unet_3D_icl", 1, NCLS, device="cpu", patch_size=PATCH, zero_stochastic=True,
                        generator=torch.Generator().manual_seed(3))
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    met_zero = make_icl_step(model, opt, NCLS, LABELED_BS, (PATCH,) * 3, CONSIS)(
        {"image": x, "label": y})
    assert not torch.equal(met_zero["loss_ce"], met_off["loss_ce"])


def test_brats_supervised_batches_match_jax():
    cases = synthetic_brats_cases(5, 40, seed=2)
    kw = dict(batch_size=2, patch_size=(24, 32, 16), seed=9)
    got, want = brats_supervised_batches(cases, **kw), jax_brats_supervised_batches(cases, **kw)
    for _ in range(5):  # two epochs of two batches, and into the third
        g, w = next(got), next(want)
        np.testing.assert_array_equal(g["image"], np.moveaxis(w["image"], -1, 1))
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["image"].dtype == np.float32 and g["label"].dtype == np.uint8
    with pytest.raises(ValueError, match="cannot fill a batch"):
        next(brats_supervised_batches(cases[:1], **kw))


# module, model, exp, labeled cases, the CLI's own flags
CLIS = {
    "icl": ("train_inherent_consistent_unet_3D_BraTS", "unet_3D_icl", "ICL", 2,
            ["--total_num", "4", "--labeled_bs", "2", "--precision", "float32"]),
    "supervised": ("train_fully_supervised_unet_3D_BraTS", "unet_3D", "Fully_Supervised", 4, []),
}


@pytest.mark.parametrize("kind", sorted(CLIS))
def test_cli_refuses_unported_flags_and_needs_cuda(kind, monkeypatch):
    import importlib

    cli = importlib.import_module(f"icl_tpu_torch.scripts.{CLIS[kind][0]}")
    for flags in (["--state_dtype", "bfloat16"],):
        with pytest.raises(SystemExit):
            cli.parse_args(flags)
    args = cli.parse_args(["--scan_steps", "8", "--dispatch_depth", "2"])
    assert (args.scan_steps, args.dispatch_depth) == (8, 2)
    args = cli.parse_args(["--scan_steps", "1"])
    assert (args.model, args.patch_size, args.batch_size, args.base_lr, args.device) == (
        CLIS[kind][1], [96, 96, 96], 4, 0.01, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--root_path", "unused"])
    if kind == "icl":
        assert_takes_multi_process_flags(cli)
    else:
        with pytest.raises(SystemExit):
            cli.parse_args(["--num_processes", "2"])


@pytest.mark.parametrize("kind", sorted(CLIS))
def test_cli_trains_on_cpu_and_eval_cli_reproduces_val_dice(kind, tmp_path, monkeypatch):
    """Two steps at 32^3, batch 4 (ICL: 2 labeled cases, 2 labeled per
    batch; supervised: the 4 training cases), f32, validation at step 2 on
    two held-out 40^3 cases; the best checkpoint then loads strictly into
    UNet3D through `test_3D_BraTS --model <the model>` and gives the same
    mean dice, exactly."""
    pytest.importorskip("h5py")
    import importlib

    from icl_tpu_torch.scripts import test_3D_BraTS

    module, model, exp, labeled, extra = CLIS[kind]
    cli = importlib.import_module(f"icl_tpu_torch.scripts.{module}")
    root = tmp_path / "BraTS"
    make_synthetic_brats(str(root), num_cases=6, size=40, seed=0)
    monkeypatch.chdir(root)  # snapshots land in ../experiments
    common = ["--root_path", str(root), "--exp", f"BraTS/{exp}", "--labeled_num", str(labeled),
              "--num_tries", "t", "--patch_size", "32", "32", "32", "--device", "cpu"]
    result = cli.main(common + ["--max_iterations", "2", "--val_interval", "2", "--seed", "3"]
                      + extra)
    keys = METRIC_KEYS if kind == "icl" else SUPERVISED_METRIC_KEYS
    assert [r["iteration"] for r in result["log"]] == [1, 2]
    assert all(set(keys) <= set(r) and all(np.isfinite(r[k]) for k in keys) for r in result["log"])
    assert result["best_mean_dice"] > 0 and result["best_path"] is not None
    snapshot = tmp_path / "experiments" / "BraTS" / f"{exp}_{labeled}_labeled" / f"{model}_exp_t"
    assert (snapshot / "model" / "model_best.pth").exists()
    total = test_3D_BraTS.main(common + ["--model", model])
    assert total[0] == result["vals"][-1]["mean_dice"]
