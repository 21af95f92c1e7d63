"""Offline BraTS2019 preprocessing: FLAIR NIfTI to normalised h5 volumes
(counterpart of `scripts/preprocess_brats.py`, the reference's
`code/dataloaders/brats_proprecessing.py`), on the host.

    python -m icl_tpu_torch.scripts.preprocess_brats \\
        --input_glob '/data/BraTS19/*/*_flair.nii.gz' --output_dir ../data/BraTS2019

Each case with a `seg` file beside its FLAIR is cropped to the bounding box
of its nonzero voxels, clipped above the intensity where the cumulative
distribution reaches 99.9%, normalised by the mean and std of its nonzero
voxels (f32), its label made whole-tumour (label > 0 -> 1, uint8), and
written as `data/{case}.h5` ('image', 'label', gzip), with
`all_cases.txt`: the layout `data.brats.BraTS2019Dataset` reads. NIfTI is
read by `data.nifti`.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from icl_tpu_torch.data.nifti import load_nifti


def brain_bbox(data: np.ndarray, gt: np.ndarray):
    """Both arrays cut to [min, max) of the nonzero voxels of `data` in each
    axis (the reference's slice, which leaves out the last nonzero index)."""
    vox = np.where(data != 0)
    sl = tuple(slice(int(v.min()), int(v.max())) for v in vox)
    return data[sl], gt[sl]


def clip_at_percentile(img: np.ndarray, percent: float = 0.999) -> np.ndarray:
    """Clip above the first intensity whose cumulative share of voxels
    reaches `percent` (skimage's cumulative_distribution)."""
    values, counts = np.unique(img, return_counts=True)
    cdf = np.cumsum(counts) / img.size
    return np.clip(img, img.min(), values[cdf >= percent][0])


def normalize_nonzero(volume: np.ndarray) -> np.ndarray:
    """(volume - mean) / std of its positive voxels, in f32."""
    pixels = volume[volume > 0]
    return ((volume - pixels.mean()) / pixels.std()).astype(np.float32)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_glob", type=str, required=True,
                   help="e.g. '/data/BraTS19/*/*_flair.nii.gz'")
    p.add_argument("--output_dir", type=str, required=True)
    return p.parse_args(argv)


def main(argv=None) -> None:
    import h5py  # the host's writer; nothing else of the port needs it

    args = parse_args(argv)
    out_data = os.path.join(args.output_dir, "data")
    os.makedirs(out_data, exist_ok=True)
    cases = []
    for path in sorted(glob.glob(args.input_glob)):
        seg_path = path.replace("flair", "seg")
        if not os.path.exists(seg_path):
            print(f"no seg for {path}, skipping")
            continue
        data = np.transpose(load_nifti(path).data, (2, 1, 0))
        lab = np.transpose(load_nifti(seg_path).data, (2, 1, 0))
        img, lab = brain_bbox(data, lab)
        img = normalize_nonzero(clip_at_percentile(img, 0.999))
        lab = (lab > 0).astype(np.uint8)
        uid = os.path.basename(path).replace("_flair.nii.gz", "")
        with h5py.File(os.path.join(out_data, f"{uid}.h5"), "w") as f:
            f.create_dataset("image", data=img, compression="gzip")
            f.create_dataset("label", data=lab, compression="gzip")
        cases.append(uid)
    with open(os.path.join(args.output_dir, "all_cases.txt"), "w") as f:
        f.write("\n".join(cases) + "\n")
    print(f"Processed {len(cases)} BraTS cases")


if __name__ == "__main__":
    main()
