"""Offline ACDC preprocessing: NIfTI frames to volume and slice h5 files
(counterpart of `scripts/preprocess_acdc.py`, the reference's
`code/dataloaders/acdc_data_processing.py`), on the host.

    python -m icl_tpu_torch.scripts.preprocess_acdc \\
        --input_glob '/data/ACDC/training/patient*/*_frame[0-9][0-9].nii.gz' \\
        --output_dir ../ACDC

Each frame with a `_gt` mask beside it is min-max normalised to [0, 1]
(f32) and written as `volumes/{frame}.h5` ('image' [z, y, x] f32, 'label'
uint8, gzip) and as one `slices/{frame}_slice_{z}.h5` per slice, with
`train_slices.list` and `all_volumes.list`: the JAX script's layout, which
`data.acdc.ACDCDataset` reads. The reference writes its label under the
key 'mask', which its own loader does not read; both packages write
'label'. NIfTI is read by `data.nifti`.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from icl_tpu_torch.data.nifti import load_nifti


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_glob", type=str, required=True,
                   help="e.g. '/data/ACDC/training/patient*/*_frame[0-9][0-9].nii.gz'")
    p.add_argument("--output_dir", type=str, required=True)
    return p.parse_args(argv)


def main(argv=None) -> None:
    import h5py  # the host's writer; nothing else of the port needs it

    args = parse_args(argv)
    os.makedirs(os.path.join(args.output_dir, "volumes"), exist_ok=True)
    os.makedirs(os.path.join(args.output_dir, "slices"), exist_ok=True)
    train_slices, volumes = [], []
    for case in sorted(glob.glob(args.input_glob)):
        msk_path = case.replace(".nii", "_gt.nii")
        if not os.path.exists(msk_path):
            continue
        item = os.path.basename(case).split(".")[0]
        # the reader gives [x, y, z]; the reference's SimpleITK arrays are [z, y, x]
        image = np.transpose(load_nifti(case).data, (2, 1, 0))
        mask = np.transpose(load_nifti(msk_path).data, (2, 1, 0))
        if image.shape != mask.shape:
            print(f"shape mismatch for {item}, skipping")
            continue
        image = (image - image.min()) / max(image.max() - image.min(), 1e-8)
        image = image.astype(np.float32)
        with h5py.File(os.path.join(args.output_dir, "volumes", f"{item}.h5"), "w") as f:
            f.create_dataset("image", data=image, compression="gzip")
            f.create_dataset("label", data=mask.astype(np.uint8), compression="gzip")
        volumes.append(item)
        for si in range(image.shape[0]):
            sid = f"{item}_slice_{si}"
            with h5py.File(os.path.join(args.output_dir, "slices", f"{sid}.h5"), "w") as f:
                f.create_dataset("image", data=image[si], compression="gzip")
                f.create_dataset("label", data=mask[si].astype(np.uint8), compression="gzip")
            train_slices.append(sid)
    with open(os.path.join(args.output_dir, "train_slices.list"), "w") as f:
        f.write("\n".join(train_slices) + "\n")
    with open(os.path.join(args.output_dir, "all_volumes.list"), "w") as f:
        f.write("\n".join(volumes) + "\n")
    print(f"Converted {len(volumes)} ACDC volumes to {len(train_slices)} 2D slices")


if __name__ == "__main__":
    main()
