"""icl_tpu_torch's tools against the JAX package's: `utils.profiling.trace`
writes a Chrome trace of the CPU's ops and `StepTimer` meters after its
warm-up; `utils.visualize` has the JAX palette and writes the same images
through a recording TensorBoard writer as the JAX `write_prediction_panel`
(class maps channel-first here, channel-last in JAX); and both
preprocessing scripts, run on the same synthetic NIfTI files as the JAX
scripts, write the same files and the same h5 datasets bit for bit, which
the port's readers read back (`ACDCDataset`, `BraTS2019Dataset`).
"""
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from icl_tpu.data.nifti import save_nifti
from icl_tpu.utils import profiling as jax_profiling
from icl_tpu.utils import visualize as jax_visualize

from icl_tpu_torch.data.acdc import ACDCDataset
from icl_tpu_torch.data.brats import BraTS2019Dataset
from icl_tpu_torch.scripts import preprocess_acdc, preprocess_brats
from icl_tpu_torch.utils import profiling, visualize
from icl_tpu_torch.utils.logging_utils import ScalarWriter
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_writes_a_chrome_trace_of_the_ops(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        assert prof.trace_path is None
        torch.mm(x, x).relu_()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu_" in names
    with profiling.trace(str(tmp_path / "trace")) as second:
        torch.mm(x, x)
    assert second.trace_path != prof.trace_path
    assert len(glob.glob(str(tmp_path / "trace" / "*.json"))) == 2


def test_step_timer_meters_after_its_warmup():
    for cls in (profiling.StepTimer, jax_profiling.StepTimer):
        timer = cls(warmup_steps=2)
        assert timer.steps_per_sec == 0.0
        timer.tick()
        timer.tick()
        assert timer.steps_per_sec == 0.0
        for _ in range(3):
            time.sleep(0.01)
            timer.tick()
        assert 0 < timer.steps_per_sec <= 3 / 0.03


class _RecordingTB:
    def __init__(self):
        self.calls = []

    def add_image(self, tag, img, step, dataformats):
        self.calls.append((tag, np.asarray(img).copy(), step, dataformats))


class _Writer:
    def __init__(self):
        self._tb = _RecordingTB()


def test_palette_and_prediction_panel_match_jax():
    np.testing.assert_array_equal(visualize.PALETTE, jax_visualize._PALETTE)
    rng = np.random.default_rng(0)
    image = rng.standard_normal((20, 24)).astype(np.float32) * 7
    label, pred = rng.integers(0, 20, (2, 20, 24))
    maps = [rng.standard_normal((2, 4, 10, 12)), rng.standard_normal((2, 4, 5, 6))]
    got, want = _Writer(), _Writer()
    visualize.write_prediction_panel(got, "val", torch.from_numpy(image), label, torch.from_numpy(pred), 7,
                                     feat_maps=[torch.from_numpy(m) for m in maps])
    jax_visualize.write_prediction_panel(want, "val", image, label, pred, 7,
                                         feat_maps=[np.moveaxis(m, 1, -1) for m in maps])
    assert [c[0] for c in got._tb.calls] == ["val/image", "val/gt", "val/pred", "val/aux_scale0",
                                             "val/aux_scale1"]
    for g, w in zip(got._tb.calls, want._tb.calls):
        assert (g[0], g[2], g[3]) == (w[0], w[2], w[3])
        assert g[1].dtype == w[1].dtype == np.uint8
        np.testing.assert_array_equal(g[1], w[1])
    np.testing.assert_allclose(visualize.normalize_image(image), jax_visualize.normalize_image(image))
    visualize.write_prediction_panel(object(), "val", image, label, pred, 0)  # no writer: nothing


def test_prediction_panel_through_a_scalar_writer(tmp_path):
    """The ScalarWriter's TensorBoard writer takes the panel (tensorboardX
    here); its scalars file is untouched."""
    writer = ScalarWriter(str(tmp_path / "log"))
    if writer._tb is None:
        pytest.skip("tensorboardX does not import")
    rng = np.random.default_rng(1)
    visualize.write_prediction_panel(writer, "val", rng.random((16, 16)), rng.integers(0, 4, (16, 16)),
                                     rng.integers(0, 4, (16, 16)), 3)
    writer.close()
    assert glob.glob(str(tmp_path / "log" / "events.out.tfevents.*"))
    assert open(tmp_path / "log" / "scalars.jsonl").read() == ""


def _h5_tree(root) -> dict:
    import h5py

    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)):
        rel = os.path.relpath(path, root)
        if path.endswith(".h5"):
            with h5py.File(path, "r") as f:
                out[rel] = {k: f[k][()] for k in f}
        elif os.path.isfile(path):
            out[rel] = open(path).read()
    return out


def _assert_same_tree(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for rel, value in want.items():
        if isinstance(value, dict):
            assert sorted(got[rel]) == sorted(value), rel
            for k, arr in value.items():
                assert got[rel][k].dtype == arr.dtype and got[rel][k].shape == arr.shape, (rel, k)
                np.testing.assert_array_equal(got[rel][k], arr, err_msg=f"{rel}:{k}")
        else:
            assert got[rel] == value, rel


def _run_jax_script(name: str, argv: list) -> str:
    res = subprocess.run([sys.executable, f"scripts/{name}.py", *argv], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_preprocess_acdc_writes_the_jax_scripts_files(tmp_path, capsys):
    rng = np.random.default_rng(2)
    for patient in ("patient001", "patient002"):
        raw = tmp_path / "raw" / patient
        raw.mkdir(parents=True)
        for frame in ("01", "12"):
            save_nifti(str(raw / f"{patient}_frame{frame}.nii.gz"),
                       rng.normal(100, 40, (20, 24, 5)).astype(np.float32))
            save_nifti(str(raw / f"{patient}_frame{frame}_gt.nii.gz"),
                       rng.integers(0, 4, (20, 24, 5)).astype(np.uint8))
    save_nifti(str(tmp_path / "raw" / "patient002" / "patient002_frame99.nii.gz"),
               np.zeros((20, 24, 5), np.float32))  # no mask beside it: skipped by both
    argv = ["--input_glob", str(tmp_path / "raw" / "*" / "*_frame[0-9][0-9].nii.gz")]
    out = _run_jax_script("preprocess_acdc", argv + ["--output_dir", str(tmp_path / "jax")])
    preprocess_acdc.main(argv + ["--output_dir", str(tmp_path / "port")])
    assert capsys.readouterr().out.strip() == out.strip() == "Converted 4 ACDC volumes to 20 2D slices"
    _assert_same_tree(_h5_tree(tmp_path / "port"), _h5_tree(tmp_path / "jax"))
    ds = ACDCDataset(str(tmp_path / "port"), "train")
    assert len(ds) == 20
    item = ds[7]
    assert item["image"].shape == (24, 20) and item["image"].dtype == np.float32
    assert 0.0 <= item["image"].min() and item["image"].max() <= 1.0 and item["label"].dtype == np.uint8


def test_preprocess_brats_writes_the_jax_scripts_files(tmp_path, capsys):
    rng = np.random.default_rng(3)
    for case in ("BraTS19_A_1", "BraTS19_B_2"):
        d = tmp_path / "raw" / case
        d.mkdir(parents=True)
        flair = np.zeros((26, 22, 18), np.float32)
        flair[3:22, 4:19, 2:15] = rng.gamma(2.0, 50.0, (19, 15, 13)).astype(np.float32)
        seg = np.zeros((26, 22, 18), np.uint8)
        seg[8:14, 7:12, 5:9] = rng.integers(0, 5, (6, 5, 4))
        save_nifti(str(d / f"{case}_flair.nii.gz"), flair)
        save_nifti(str(d / f"{case}_seg.nii.gz"), seg)
    argv = ["--input_glob", str(tmp_path / "raw" / "*" / "*_flair.nii.gz")]
    out = _run_jax_script("preprocess_brats", argv + ["--output_dir", str(tmp_path / "jax")])
    preprocess_brats.main(argv + ["--output_dir", str(tmp_path / "port")])
    assert capsys.readouterr().out.strip() == out.strip() == "Processed 2 BraTS cases"
    _assert_same_tree(_h5_tree(tmp_path / "port"), _h5_tree(tmp_path / "jax"))
    ds = BraTS2019Dataset(str(tmp_path / "port"), "all_cases")
    assert [ds[i]["case"] for i in range(len(ds))] == ["BraTS19_A_1", "BraTS19_B_2"]
    item = ds[0]
    assert item["image"].dtype == np.float32 and set(np.unique(item["label"])) <= {0, 1}
    assert item["image"].shape == (12, 14, 18)  # the bounding box [min, max) of the brain
