"""The port's three fully supervised CLIs end to end on the CPU: two steps
of each with a validation at step 2, the Swin CLIs from a synthetic
pretrained checkpoint in the reference layout, then the eval CLI on the
best checkpoint gives the trainer's validation dice exactly; the flags
each CLI refuses, takes, and its need of a card.

Small sizes: the U-Net at 32^2, Swin-UNet at embed 12, 64^2, window 4 (a
`--cfg` yaml), SwinUNETR at feature size 12, 32^3; batch 4, f32. The
ACDC and BraTS trees are the JAX package's synthetic fixtures; the
pretrained checkpoints are made from the port's own seeded models (the
loaders are held against the JAX ones in `test_torch_supervised.py`).
"""
import numpy as np
import pytest
import torch

from icl_tpu.data.synth import make_synthetic_acdc, make_synthetic_brats

from icl_tpu_torch.models import swin2d
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.steps import SUPERVISED_METRIC_KEYS
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)


def _acdc(tmp_path, monkeypatch):
    root = tmp_path / "ACDC"
    make_synthetic_acdc(str(root), num_slices=72, num_volumes=2, slice_size=40, vol_depth=3, seed=0)
    monkeypatch.chdir(root)  # snapshots land in ../experiments
    return root


def _trained(result, snapshot):
    assert [r["iteration"] for r in result["log"]] == [1, 2]
    assert all(np.isfinite(r[k]) for r in result["log"] for k in SUPERVISED_METRIC_KEYS)
    assert result["best_mean_dice"] > 0 and result["best_path"] is not None
    assert (snapshot / "model" / "model_best.pth").exists()
    assert torch.load(snapshot / "model" / "state_last.pt", weights_only=True)["iteration"] == 2
    return result["vals"][-1]["mean_dice"]


def test_clis_refuse_unported_flags_and_need_cuda(monkeypatch):
    from icl_tpu_torch.scripts import train_fully_supervised_swinunet_2D_ACDC as swin
    from icl_tpu_torch.scripts import train_fully_supervised_swinunetr_3D_BraTS as swinunetr
    from icl_tpu_torch.scripts import train_fully_supervised_unet_2D_ACDC as unet

    want = {unet: ("unet", [256, 256], 16, "float32"), swin: ("swinunet", [224, 224], 16, "float32"),
            swinunetr: ("swinunetr", [96, 96, 96], 4, "bfloat16")}
    for cli, (model, patch, batch, precision) in want.items():
        args = cli.parse_args(["--scan_steps", "1", "--dispatch_depth", "1"])
        assert (args.model, args.patch_size, args.batch_size, args.precision) == (
            model, patch, batch, precision)
        assert (args.base_lr, args.max_iterations, args.val_interval, args.device) == (
            0.01, 30000, 200, "cuda")
        assert (args.scan_steps, args.dispatch_depth) == (1, 1)
        args = cli.parse_args(["--scan_steps", "2", "--dispatch_depth", "4"])
        assert (args.scan_steps, args.dispatch_depth) == (2, 4)
    assert swinunetr.parse_args([]).use_ssl_pretrained == 1
    assert swinunetr.parse_args([]).ssl_ckpt == "../pretrained_models/model_swinvit.pt"
    assert (swinunetr.parse_args([]).feature_size, swinunetr.parse_args([]).labeled_num) == (48, 25)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in want:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--root_path", "unused"])


def test_unet_cli_trains_on_cpu_and_eval_cli_reproduces_val_dice(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_fully_supervised_unet_2D_ACDC as cli

    root = _acdc(tmp_path, monkeypatch)
    common = ["--root_path", str(root), "--exp", "ACDC/FS", "--labeled_num", "3", "--num_tries", "t",
              "--patch_size", "32", "32", "--device", "cpu"]
    result = cli.main(common + ["--max_iterations", "2", "--val_interval", "2", "--batch_size", "4"])
    dice = _trained(result, tmp_path / "experiments" / "ACDC" / "FS_3_labeled" / "unet_exp_t")
    assert test_2D_ACDC.main(common + ["--model", "unet"])[0] == dice


def test_swinunet_cli_from_pretrained_reproduces_val_dice(tmp_path, monkeypatch):
    """`--pretrained_ckpt`: the encoder of another seeded Swin-UNet in the
    ImageNet layout, with a head; the run starts from those weights."""
    pytest.importorskip("h5py")
    pytest.importorskip("yaml")
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_fully_supervised_swinunet_2D_ACDC as cli

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(open("configs/swin_tiny_patch4_window7_224_lite.yaml").read()
                   .replace("EMBED_DIM: 96", "EMBED_DIM: 12").replace("WINDOW_SIZE: 7", "WINDOW_SIZE: 4"))
    donor = net_factory("swinunet", 1, 4, device="cpu", generator=torch.Generator().manual_seed(9),
                        swin_cfg=swin2d.SwinConfig(img_size=64, window_size=4, embed_dim=12))
    encoder = {k[len("swin_unet."):]: v for k, v in donor.state_dict().items()
               if k.startswith(("swin_unet.layers.", "swin_unet.patch_embed."))}
    torch.save({"model": {**encoder, "head.weight": torch.ones(10, 96)}}, tmp_path / "swin_t.pth")

    loaded = {}
    real_fit = cli.Trainer.fit

    def fit(self, *a, **k):  # the weights the run starts from
        loaded.update({k: v.clone() for k, v in self.model.state_dict().items()})
        return real_fit(self, *a, **k)

    monkeypatch.setattr(cli.Trainer, "fit", fit)
    root = _acdc(tmp_path, monkeypatch)
    common = ["--root_path", str(root), "--exp", "ACDC/FS", "--labeled_num", "3", "--num_tries", "t",
              "--patch_size", "64", "64", "--cfg", str(cfg), "--device", "cpu"]
    result = cli.main(common + ["--max_iterations", "2", "--val_interval", "2", "--batch_size", "4",
                                "--pretrained_ckpt", str(tmp_path / "swin_t.pth")])
    for k, v in encoder.items():
        assert torch.equal(loaded[f"swin_unet.{k}"], v), k
    mirrored = "layers_up.3.blocks.0.attn.qkv.weight"
    assert torch.equal(loaded[f"swin_unet.{mirrored}"], encoder["layers.0.blocks.0.attn.qkv.weight"])
    dice = _trained(result, tmp_path / "experiments" / "ACDC" / "FS_3_labeled" / "swinunet_exp_t")
    assert test_2D_ACDC.main(common + ["--model", "swinunet"])[0] == dice


def test_swinunetr_cli_from_ssl_reproduces_val_dice(tmp_path, monkeypatch):
    """`--use_ssl_pretrained 1 --ssl_ckpt`: another seeded SwinUNETR's
    encoder in MONAI's SSL layout (`module.swin_vit.`, `fc1/fc2`); a
    missing file is an error."""
    pytest.importorskip("h5py")
    from icl_tpu_torch.scripts import test_3D_BraTS
    from icl_tpu_torch.scripts import train_fully_supervised_swinunetr_3D_BraTS as cli

    donor = net_factory("swinunetr", 1, 2, device="cpu", feature_size=12,
                        generator=torch.Generator().manual_seed(9))
    encoder = {k: v for k, v in donor.state_dict().items() if k.startswith("swinViT.")
               and not k.endswith("relative_position_index")}
    ssl = {"module.swin_vit." + k[len("swinViT."):].replace(".linear1.", ".fc1.")
           .replace(".linear2.", ".fc2."): v for k, v in encoder.items()}
    torch.save({"state_dict": ssl, "epoch": 1}, tmp_path / "model_swinvit.pt")
    root = tmp_path / "BraTS"
    make_synthetic_brats(str(root), num_cases=6, size=40, seed=0)
    monkeypatch.chdir(root)
    common = ["--root_path", str(root), "--exp", "BraTS/FS", "--labeled_num", "4", "--num_tries", "t",
              "--patch_size", "32", "32", "32", "--feature_size", "12", "--device", "cpu"]
    train = common + ["--max_iterations", "2", "--val_interval", "2", "--precision", "float32"]
    with pytest.raises(FileNotFoundError):
        cli.main(train + ["--ssl_ckpt", str(tmp_path / "missing.pt")])

    loaded = {}
    real_fit = cli.Trainer.fit

    def fit(self, *a, **k):
        loaded.update({k: v.clone() for k, v in self.model.state_dict().items()})
        return real_fit(self, *a, **k)

    monkeypatch.setattr(cli.Trainer, "fit", fit)
    result = cli.main(train + ["--ssl_ckpt", str(tmp_path / "model_swinvit.pt")])
    for k, v in encoder.items():
        assert torch.equal(loaded[k], v), k
    dice = _trained(result, tmp_path / "experiments" / "BraTS" / "FS_4_labeled" / "swinunetr_exp_t")
    total = test_3D_BraTS.main(common + ["--model", "swinunetr"])
    assert total[0] == dice
