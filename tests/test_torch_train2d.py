"""icl_tpu_torch's Swin-UNet-ICL 2D training path against the JAX
package's: one ICL train step (metrics, gradients, new parameters,
BatchNorm stats), the attention calls of a step, the ACDC batches and
transforms, the synthetic slices and volumes, the 2D slice predictor and
its validation metrics, and a tiny training run through the CLI on the
CPU whose stripped best checkpoint reproduces the validation dice through
the eval CLI.

Small size as `test_torch_swin2d.py`: embed 12, 96^2, window 12, 4
classes, batch 4 with 2 labeled, drop path off on both sides, f32, JAX
matmuls at "highest", the JAX attention through its Pallas kernels in
interpret mode where N = 144. Tolerances: metrics 1e-4 relative; each
gradient and each parameter update within 1e-3 of its largest magnitude
plus 1e-6 (sums over ~10^4 pixels through two deep passes in another
order); running means 1e-5; label maps of the predictor equal.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.data.acdc import ACDCDataset as JaxACDCDataset
from icl_tpu.data.pipeline import acdc_train_batches as jax_acdc_train_batches
from icl_tpu.data.synth import make_synthetic_acdc
from icl_tpu.eval.infer2d import evaluate_acdc_volumes as jax_evaluate_acdc_volumes
from icl_tpu.eval.infer2d import make_slice_predictor as jax_make_slice_predictor
from icl_tpu.train.optim import make_sgd
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_icl_step as jax_make_icl_step

from icl_tpu_torch.data.acdc import ACDCDataset, patients_to_slices
from icl_tpu_torch.data.pipeline import acdc_train_batches
from icl_tpu_torch.data.synth import synthetic_acdc
from icl_tpu_torch.eval.infer2d import evaluate_acdc_volumes, make_slice_predictor
from icl_tpu_torch.ops import window_attention as wa
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import METRIC_KEYS, make_icl_step
from icl_tpu_torch.utils.convert import icl_swinunet2d_state_dict_from_jax
from test_torch_icl import expected_running_var, no_drop_path  # noqa: F401  (a fixture)
from test_torch_swin2d import (  # noqa: F401  (pallas_interpret is a fixture)
    IMG, LABELED_BS, NCLS, WINDOW, images, jax_variables, pallas_interpret, port_model)
from test_torch_train import _assert_close_to_scale, _capture_grads
from _torch_dp import assert_takes_multi_process_flags
from _torch_native import native_on_both, scipy_on_both  # noqa: F401  (fixtures)
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

BASE_LR, MAX_IT, CONSIS = 0.01, 10, 50.0


def _labels(seed: int, n: int = 2 * LABELED_BS) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, NCLS, (n, IMG, IMG)).astype(np.int32)


def test_icl_step_matches_jax(no_drop_path, pallas_interpret):
    jax_model, params, bs = jax_variables(5)
    x, xt = images(6)
    y = _labels(7)
    tx = optax.chain(_capture_grads(), make_sgd(BASE_LR, MAX_IT))
    step = jax_make_icl_step(jax_model, tx, NCLS, LABELED_BS, (IMG, IMG), CONSIS)
    new_state, met_j = jax.jit(step)(TrainState.create(params, bs, tx),
                                     {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                                     jax.random.PRNGKey(0))

    model = port_model(params, bs).train()
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    met_p = make_icl_step(model, opt, NCLS, LABELED_BS, (IMG, IMG), CONSIS)(
        {"image": torch.from_numpy(xt), "label": torch.from_numpy(y).long()})

    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(met_p[k]), float(met_j[k]), rtol=1e-4, err_msg=k)
    new_bs = new_state.batch_stats
    grads = icl_swinunet2d_state_dict_from_jax(new_state.opt_state[0], new_bs, IMG, WINDOW)
    new = icl_swinunet2d_state_dict_from_jax(new_state.params, new_bs, IMG, WINDOW)
    old = icl_swinunet2d_state_dict_from_jax(params, bs, IMG, WINDOW)
    for name, p in model.named_parameters():
        _assert_close_to_scale(p.grad, grads[name], f"grad {name}")
        _assert_close_to_scale(p.detach() - old[name], new[name] - old[name], f"update {name}")
    sd = model.state_dict()
    for name in sd:
        if name.endswith("running_mean"):
            np.testing.assert_allclose(sd[name].numpy(), new[name].numpy(), atol=1e-5, err_msg=name)
        elif name.endswith("running_var"):
            r = (6, 12, 24)[int(name.split("attn_convs0.")[1].split(".")[0])]
            updates = 2 if name.startswith("sspa.") else 1
            want = expected_running_var(old[name].numpy(), new[name].numpy(),
                                        LABELED_BS * NCLS * r * r, updates)
            np.testing.assert_allclose(sd[name].numpy(), want, atol=1e-5, err_msg=name)


def test_step_attention_calls_forward_and_backward(monkeypatch):
    """The attention calls of one step, counted on the CPU path: 14 Swin
    blocks per backbone pass (8 encoder, 6 decoder), two passes, no
    recompute: 28 forward and 28 backward calls, those of the two shifted
    blocks with N = 144 at this size with the dense mask. `chip_smoke.py`
    asserts the kernels' launches at 384^2 (12 of the 28 masked)."""
    calls = {"fwd": {"none": 0, "mask": 0}, "bwd": {"none": 0, "mask": 0}}
    plain_fwd, plain_bwd = wa.window_attention_plain, wa.window_attention_plain_bwd

    def fwd(q, k, v, bias, region_ids=None, mask=None, *, scale):
        calls["fwd"]["mask" if mask is not None else "none"] += 1
        return plain_fwd(q, k, v, bias, region_ids, mask, scale=scale)

    def bwd(*a, mask=None, **kw):
        calls["bwd"]["mask" if mask is not None else "none"] += 1
        return plain_bwd(*a, mask=mask, **kw)

    monkeypatch.setattr(wa, "window_attention_plain", fwd)
    monkeypatch.setattr(wa, "window_attention_plain_bwd", bwd)
    _, params, bs = jax_variables(8)
    model = port_model(params, bs).train()
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    _, xt = images(9)
    metrics = make_icl_step(model, opt, NCLS, LABELED_BS, (IMG, IMG), CONSIS)(
        {"image": torch.from_numpy(xt), "label": torch.from_numpy(_labels(10)).long()})
    assert all(torch.isfinite(v) for v in metrics.values())
    assert calls == {"fwd": {"none": 24, "mask": 4}, "bwd": {"none": 24, "mask": 4}}


def test_synthetic_acdc_matches_the_jax_fixture(tmp_path):
    h5py = pytest.importorskip("h5py")
    make_synthetic_acdc(str(tmp_path), num_slices=5, num_volumes=2, slice_size=24, vol_depth=3,
                        seed=4)
    slices, volumes = synthetic_acdc(5, 2, 24, 3, seed=4)
    for items, sub in ((slices, "slices"), (volumes, "volumes")):
        for item in items:
            with h5py.File(tmp_path / sub / f"{item['case']}.h5", "r") as f:
                np.testing.assert_array_equal(item["image"], f["image"][:])
                np.testing.assert_array_equal(item["label"], f["label"][:])
    port_ds = ACDCDataset(str(tmp_path), "train")
    assert [port_ds[i]["case"] for i in range(len(port_ds))] == [s["case"] for s in slices]
    assert len(ACDCDataset(str(tmp_path), "val_test")) == 2


def test_acdc_batches_match_jax(tmp_path, scipy_on_both):
    """Five batches of 4 from one seed, read from an h5 tree by each
    package's own dataset: the same arrays, array for array; the seed
    reaches both augmentation branches. Both packages rotate and zoom
    through scipy, the reference's code."""
    _assert_acdc_batches_match(tmp_path)


def test_acdc_batches_match_jax_on_the_native_path(tmp_path, native_on_both):
    """The same, each package through its own C++ rotate and zoom."""
    _assert_acdc_batches_match(tmp_path)


def _assert_acdc_batches_match(tmp_path):
    pytest.importorskip("h5py")
    root = str(tmp_path / "ACDC")
    make_synthetic_acdc(root, num_slices=12, num_volumes=1, slice_size=40, seed=1)
    kw = dict(labeled_count=5, batch_size=4, labeled_bs=2, patch_size=(48, 32), seed=3)
    got = acdc_train_batches(ACDCDataset(root, "train"), **kw)
    want = jax_acdc_train_batches(JaxACDCDataset(root, "train"), **kw)
    for _ in range(5):
        g, w = next(got), next(want)
        assert g["image"].shape == (4, 1, 48, 32) and g["image"].dtype == np.float32
        np.testing.assert_array_equal(g["image"], np.moveaxis(w["image"], -1, 1))
        np.testing.assert_array_equal(g["label"], w["label"])
    assert patients_to_slices(root, 3) == 68


def test_slice_predictor_and_validation_match_jax(pallas_interpret):
    """Two volumes of 40 slices (a chunk of 32 and one of 8) at 72^2,
    zoomed to the 96^2 patch and back: the label maps and the validation
    metrics of both packages on the same weights."""
    jax_model, params, bs = jax_variables(11)
    model = port_model(params, bs).eval()
    _, volumes = synthetic_acdc(0, 2, 72, 40, seed=12)
    jax_predict = jax_make_slice_predictor(jax_model, (IMG, IMG))
    variables = {"params": params, "batch_stats": bs}
    predict = make_slice_predictor(model, (IMG, IMG), device="cpu")
    for vol in volumes:
        np.testing.assert_array_equal(predict(vol["image"]), jax_predict(variables, vol["image"]))
    got = evaluate_acdc_volumes(predict, volumes, NCLS)
    want = jax_evaluate_acdc_volumes(jax_predict, variables, volumes, NCLS)
    assert got["mean_dice"] == want["mean_dice"] and got["mean_hd95"] == want["mean_hd95"]


def test_cli_refuses_unported_flags_and_needs_cuda(monkeypatch):
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_inherent_consistent_swinunet_2D as cli

    assert cli.parse_args(["--scan_steps", "1"]).scan_steps == 1
    args = cli.parse_args(["--scan_steps", "2", "--dispatch_depth", "4"])
    assert (args.scan_steps, args.dispatch_depth) == (2, 4)
    assert cli.parse_args(["--pretrained_ckpt", "swin.pth"]).pretrained_ckpt == "swin.pth"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--root_path", "unused"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_2D_ACDC.main(["--checkpoint", "unused.pth"])
    assert_takes_multi_process_flags(cli)


def test_cli_trains_on_cpu_and_eval_cli_reproduces_val_dice(tmp_path, monkeypatch):
    """Two steps of Swin-UNet-ICL at embed 12, 64^2, window 4 (a `--cfg`
    yaml), batch 4 (2 labeled), f32, validation at step 2 on two 3-slice
    volumes; the stripped best checkpoint then loads strictly into
    SwinUnetWrapper through the eval CLI and gives the same mean dice,
    exactly."""
    pytest.importorskip("h5py")
    pytest.importorskip("yaml")
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_inherent_consistent_swinunet_2D as cli

    root = tmp_path / "ACDC"
    make_synthetic_acdc(str(root), num_slices=72, num_volumes=2, slice_size=40, vol_depth=3, seed=0)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(open("configs/swin_tiny_patch4_window7_224_lite.yaml").read()
                   .replace("EMBED_DIM: 96", "EMBED_DIM: 12").replace("WINDOW_SIZE: 7", "WINDOW_SIZE: 4"))
    monkeypatch.chdir(root)  # snapshots land in ../experiments
    common = ["--root_path", str(root), "--exp", "ACDC/SwinICL", "--labeled_num", "3",
              "--num_tries", "t", "--patch_size", "64", "64", "--cfg", str(cfg), "--device", "cpu"]
    result = cli.main(common + ["--max_iterations", "2", "--val_interval", "2", "--batch_size", "4",
                                "--labeled_bs", "2", "--seed", "3"])
    assert [r["iteration"] for r in result["log"]] == [1, 2]
    assert all(np.isfinite(r[k]) for r in result["log"] for k in METRIC_KEYS)
    assert result["best_mean_dice"] > 0 and result["best_path"] is not None
    snapshot = tmp_path / "experiments" / "ACDC" / "SwinICL_3_labeled" / "icl_swinunet_exp_t"
    assert (snapshot / "log.txt").exists() and (snapshot / "model" / "model_best.pth").exists()
    total = test_2D_ACDC.main(common + ["--model", "icl_swinunet"])
    assert total[0] == result["vals"][-1]["mean_dice"]
