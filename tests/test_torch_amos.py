"""icl_tpu_torch's AMOS22 path against the JAX package's: the NIfTI reader
and writer (files written by either package read by the other), `to_ras`
and `voxel_spacing`, `monai_spacing_resample` on an oblique affine, the
synthetic AMOS tree, `AMOSDataset` (training and validation order),
`amos_train_batches` and `amos_supervised_batches`, `evaluate_amos_cases`
on a toy scorer, and the AMOS patch predictor (input rounded to bf16,
logits) on a U-Net 3D; then the AMOS CLIs' refusals and their need of a
card, and tiny training runs through both AMOS CLIs on the CPU whose best
checkpoints reproduce the validation dice through `test_3D_AMOS`.

Small size: synthetic volumes of 40 x 40 x 30 voxels at spacing (2, 2, 3)
(about 53 x 53 x 44 at the protocol's spacing; the validation order pads
to 96^3 first), 32^3 crops and patches, 16 classes. Tolerances: the data
path runs the same numpy arithmetic in both packages, so its arrays are
equal, bit for bit, and so are the toy scorer's metrics (its stitched
scores are small integers, exact in f32). The predictor: 1e-4 absolute
and relative (f32 convs in another order, as `test_torch_unet3d.py`).
The eval CLI's mean dice equals the trainer's.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.data import amos as jax_amos
from icl_tpu.data import nifti as jax_nifti
from icl_tpu.data.resample import monai_spacing_resample as jax_resample
from icl_tpu.data.synth import make_synthetic_amos as jax_make_synthetic_amos
from icl_tpu.eval.infer3d import evaluate_amos_cases as jax_evaluate_amos_cases
from icl_tpu.eval.infer3d import make_patch_predictor as jax_make_patch_predictor
from icl_tpu.models.unet3d import UNet3D as JaxUNet3D
from icl_tpu.utils.torch_import import export_unet3d

from icl_tpu_torch.data import amos, nifti
from icl_tpu_torch.data.resample import monai_spacing_resample
from icl_tpu_torch.data.synth import make_synthetic_amos
from icl_tpu_torch.eval.infer3d import evaluate_amos_cases, make_patch_predictor
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.steps import METRIC_KEYS, SUPERVISED_METRIC_KEYS
from test_torch_icl import cl2cf
from test_torch_unet3d import jax_variables
from _torch_dp import assert_takes_multi_process_flags
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

SHAPE, ROI, NCLS = (40, 40, 30), (32, 32, 32), 16


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(root, json path) of a port-written synthetic AMOS tree of 4 cases."""
    root = tmp_path_factory.mktemp("AMOS")
    return root, make_synthetic_amos(str(root), num_cases=4, shape=SHAPE, seed=0)


@pytest.mark.parametrize("dtype,suffix", [(np.float32, ".nii.gz"), (np.uint8, ".nii"),
                                          (np.int16, ".nii.gz")])
def test_nifti_round_trips_across_packages(tmp_path, dtype, suffix):
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(6, 7, 8)) * 50).astype(dtype)
    affine = np.array([[0.0, 0.0, -2.0, 10.0], [1.5, 0.0, 0.0, -3.0],
                       [0.0, -1.25, 0.0, 4.0], [0.0, 0.0, 0.0, 1.0]])
    for save, load in ((nifti.save_nifti, jax_nifti.load_nifti),
                       (jax_nifti.save_nifti, nifti.load_nifti),
                       (nifti.save_nifti, nifti.load_nifti)):
        path = str(tmp_path / f"vol{suffix}")
        save(path, data, affine)
        vol = load(path)
        assert vol.data.dtype == dtype
        np.testing.assert_array_equal(vol.data, data)
        np.testing.assert_allclose(vol.affine, affine, rtol=1e-6)
    port, ref = nifti.to_ras(data, affine), jax_nifti.to_ras(data, affine)
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])
    assert port[0].shape == (8, 6, 7)
    np.testing.assert_array_equal(nifti.voxel_spacing(affine), jax_nifti.voxel_spacing(affine))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_spacing_resample_matches_jax(mode):
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(13, 11, 9)).astype(np.float32)
    if mode == "nearest":
        vol = rng.integers(0, 16, size=vol.shape).astype(np.uint8)
    c, s = np.cos(0.3), np.sin(0.3)
    affine = np.array([[2.0 * c, -2.0 * s, 0.1, 5.0], [2.0 * s, 2.0 * c, 0.0, -1.0],
                       [0.0, 0.2, 3.0, 2.0], [0.0, 0.0, 0.0, 1.0]])
    got, got_affine = monai_spacing_resample(vol, affine, (1.5, 1.5, 2.0), mode=mode)
    want, want_affine = jax_resample(vol, affine, (1.5, 1.5, 2.0), mode=mode)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_affine, want_affine)


def test_synthetic_tree_matches_jax(tree, tmp_path):
    root, jpath = tree
    ref = jax_make_synthetic_amos(str(tmp_path), num_cases=4, shape=SHAPE, seed=0)
    assert json.load(open(jpath)) == json.load(open(ref))
    for i in range(4):
        for sub in ("imagesTr", "labelsTr"):
            name = f"{sub}/amos_{i:04d}.nii.gz"
            got, want = nifti.load_nifti(str(root / name)), jax_nifti.load_nifti(str(tmp_path / name))
            np.testing.assert_array_equal(got.data, want.data)
            np.testing.assert_array_equal(got.affine, want.affine)


@pytest.mark.parametrize("val_mode", [False, True], ids=["train_order", "val_order"])
def test_dataset_matches_jax(tree, val_mode):
    _, jpath = tree
    section = "validation" if val_mode else "training"
    got = amos.AMOSDataset(amos.load_decathlon_datalist(jpath, section), val_mode=val_mode)
    want = jax_amos.AMOSDataset(jax_amos.load_decathlon_datalist(jpath, section), val_mode=val_mode)
    assert got.datalist == want.datalist and len(got) == len(want) == (1 if val_mode else 3)
    item, ref = got[0], want[0]
    assert item["image"].dtype == np.float32 and item["label"].dtype == np.uint8
    np.testing.assert_array_equal(item["image"], ref["image"])
    np.testing.assert_array_equal(item["label"], ref["label"])
    if val_mode:
        assert min(item["image"].shape) > 96  # padded to 96^3 before the spacing
    g_rng, w_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(6):  # enough draws to take the flips, rotations and shifts
        (gi, gl), (wi, wl) = got.augment(0, g_rng, ROI), want.augment(0, w_rng, ROI)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_batches_match_jax(tree):
    _, jpath = tree
    datalist = amos.load_decathlon_datalist(jpath)
    got_ds, want_ds = amos.AMOSDataset(datalist), jax_amos.AMOSDataset(datalist)
    streams = [(amos.amos_train_batches(got_ds, 1, 3, 2, 1, ROI, seed=4),
                jax_amos.amos_train_batches(want_ds, 1, 3, 2, 1, ROI, seed=4)),
               (amos.amos_supervised_batches(got_ds, 3, 2, ROI, seed=6),
                jax_amos.amos_supervised_batches(want_ds, 3, 2, ROI, seed=6))]
    for got, want in streams:
        for _ in range(3):
            g, w = next(got), next(want)
            assert g["image"].shape == (2, 1) + ROI and g["image"].dtype == np.float32
            np.testing.assert_array_equal(g["image"], np.moveaxis(w["image"], -1, 1))
            np.testing.assert_array_equal(g["label"], w["label"])
    with pytest.raises(ValueError, match="cannot fill a batch"):
        next(amos.amos_supervised_batches(got_ds, 1, 2, ROI))


def test_evaluate_amos_cases_matches_jax(tree):
    """A toy scorer (class 1 where the input is as bright as an organ,
    else 0, one-hot, so every stitched score is a small integer) through
    both protocols over two training-order cases: the same per-organ
    (dice, hd95) of every case."""
    _, jpath = tree
    datalist = amos.load_decathlon_datalist(jpath)[:2]
    dataset = amos.AMOSDataset(datalist)

    def port_scores(x):
        organ = (x > 0.7).long()[:, 0]
        return torch.nn.functional.one_hot(organ, NCLS).permute(0, 4, 1, 2, 3).float()

    def jax_scores(variables, x):
        return jax.nn.one_hot((x > 0.7).astype(jnp.int32)[..., 0], NCLS)

    got = evaluate_amos_cases(port_scores, dataset, NCLS, ROI, device="cpu")
    want = jax_evaluate_amos_cases(jax_scores, None, jax_amos.AMOSDataset(datalist), NCLS, ROI)
    assert len(got) == NCLS - 1 and all(len(c) == 2 for c in got)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got)[:, 0, 0].max() > 0


def test_amos_predictor_rounds_the_input_and_stitches_logits():
    """make_patch_predictor(apply_softmax=False, dtype=bf16) against the
    JAX predictor of the same U-Net 3D: the logits of the bf16-rounded
    input, with the network in f32; not the logits of the input itself,
    nor those of an autocast forward."""
    _, params, _ = jax_variables(2)
    params = params["backbone"]
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    want = jax_make_patch_predictor(JaxUNet3D(1, 2), ROI, sw_batch=2, apply_softmax=False,
                                    dtype="bfloat16")({"params": params}, jnp.asarray(x))
    model = net_factory("unet_3D", 1, 2, device="cpu").eval()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in export_unet3d(params).items()},
                          strict=True)
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    got = make_patch_predictor(model, apply_softmax=False, dtype=torch.bfloat16)(xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), cl2cf(want), atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        assert torch.equal(got, model(xt.bfloat16().float()))
        assert not torch.equal(got, model(xt))
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert float((model(xt).float() - got).abs().max()) > 1e-3
    probs = make_patch_predictor(model)(xt)
    torch.testing.assert_close(probs, torch.softmax(model(xt).detach(), dim=1), rtol=0, atol=0)


# module, model, exp, the CLI's own flags
CLIS = {
    "icl": ("train_inherent_consistent_unet_3D_AMOS22", "unet_3D_icl", "ICL",
            ["--total_num", "3", "--labeled_bs", "1", "--batch_size", "2", "--precision", "float32"]),
    "supervised": ("train_fully_supervised_unet_3D_AMOS22", "unet_3D", "Fully_Supervised",
                   ["--batch_size", "2"]),
}


@pytest.mark.parametrize("kind", sorted(CLIS))
def test_cli_refuses_unported_flags_and_needs_cuda(kind, monkeypatch):
    import importlib

    from icl_tpu_torch.scripts import test_3D_AMOS

    cli = importlib.import_module(f"icl_tpu_torch.scripts.{CLIS[kind][0]}")
    for flags in (["--state_dtype", "bfloat16"],):
        with pytest.raises(SystemExit):
            cli.parse_args(flags)
    args = cli.parse_args(["--scan_steps", "8", "--dispatch_depth", "2"])
    assert (args.scan_steps, args.dispatch_depth) == (8, 2)
    args = cli.parse_args(["--dispatch_depth", "1"])
    assert (args.model, args.num_classes, args.patch_size, args.batch_size, args.base_lr,
            args.val_interval, args.device) == (CLIS[kind][1], 16, [96, 96, 96], 4, 0.02, 1200, "cuda")
    if kind == "icl":
        assert (args.precision, args.remat, args.labeled_bs) == ("bfloat16", 1, 2)
    else:
        assert args.precision == "float32"
    eval_args = test_3D_AMOS.parse_args([])
    assert (eval_args.model, eval_args.num_classes, eval_args.val_num) == ("unet_3D_icl", 16, 30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--root_path", "unused", "--split_path", "unused.json"])
    if kind == "icl":
        assert_takes_multi_process_flags(cli, ["--root_path", "unused", "--split_path", "unused.json"])
    else:
        with pytest.raises(SystemExit):
            cli.parse_args(["--num_processes", "2"])


@pytest.mark.parametrize("kind", sorted(CLIS))
def test_cli_trains_on_cpu_and_eval_cli_reproduces_val_dice(kind, tree, tmp_path, monkeypatch):
    """Two steps at 32^3, batch 2 (ICL: 1 labeled case of 3, 1 labeled
    per batch, recompute on; supervised: the first 2 cases), f32,
    validation at step 2 on validation[:1]; `test_3D_AMOS --val_num 0`
    then evaluates the same case with the best checkpoint loaded strictly
    into UNet3D and gives the same mean dice, exactly."""
    import importlib

    from icl_tpu_torch.scripts import test_3D_AMOS

    module, model, exp, extra = CLIS[kind]
    cli = importlib.import_module(f"icl_tpu_torch.scripts.{module}")
    root, jpath = tree
    work = tmp_path / "run"
    work.mkdir()
    monkeypatch.chdir(work)  # snapshots land in ../experiments
    labeled = "1" if kind == "icl" else "2"
    common = ["--root_path", str(root), "--split_path", jpath, "--exp", f"AMOS/{exp}",
              "--labeled_num", labeled, "--num_tries", "t", "--patch_size", "32", "32", "32",
              "--device", "cpu"]
    result = cli.main(common + ["--max_iterations", "2", "--val_interval", "2", "--val_num", "1",
                                "--seed", "3"] + extra)
    keys = METRIC_KEYS if kind == "icl" else SUPERVISED_METRIC_KEYS
    assert [r["iteration"] for r in result["log"]] == [1, 2]
    assert all(np.isfinite(r[k]) for r in result["log"] for k in keys)
    assert result["best_mean_dice"] > 0 and result["best_path"] is not None
    snapshot = tmp_path / "experiments" / "AMOS" / f"{exp}_{labeled}_labeled" / f"{model}_exp_t"
    assert (snapshot / "model" / "model_best.pth").exists()
    rows = [json.loads(line) for line in open(snapshot / "log" / "scalars.jsonl")]
    assert {r["tag"] for r in rows} >= {f"metric_class_{n}/mean_dice" for n in amos.AMOS_CLASS_NAMES}
    total = test_3D_AMOS.main(common + ["--model", model, "--val_num", "0"])
    assert total[0] == result["vals"][-1]["mean_dice"]
