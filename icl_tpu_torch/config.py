"""The `ExperimentConfig` fields the eval and training CLIs read
(counterpart of `icl_tpu/config.py:14-173`), and the two ACDC presets.

Left out: `compile_cache_dir` (an XLA compile cache; the port compiles its
kernels with `ops/build.py`, into `build/`), `mesh_data` and `mesh_model`
(the mesh shape: no JAX CLI sets a model axis; the port's `Trainer` takes
a mesh, `parallel.mesh.create_mesh(data, model)`, as the JAX one does),
and `deterministic` (the port's CLIs never read it)."""
from __future__ import annotations

import dataclasses
from typing import Sequence


# the JAX ExperimentConfig's defaults where the port's, which default to the
# SwinUNETR BraTS CLI, differ
ACDC_ICL_DEFAULTS = dict(root_path="../ACDC", exp="ACDC/Inherent_Consistent_Learning",
                         model="icl_unet", num_classes=4, batch_size=16, patch_size=(256, 256),
                         labeled_num=7)


@dataclasses.dataclass
class ExperimentConfig:
    # Reference flags
    root_path: str = "../data/BraTS2019"
    exp: str = "BraTS2019/Inherent_Consistent_Learning"
    model: str = "swinunetr_icl"
    num_classes: int = 2
    in_chns: int = 1
    max_iterations: int = 30000
    batch_size: int = 4
    # -1 = unset: min(8, batch_size), as the JAX package resolves it
    labeled_bs: int = -1
    base_lr: float = 0.01
    patch_size: Sequence[int] = (96, 96, 96)
    seed: int = 1337
    labeled_num: int = 25
    num_tries: str = "1"

    # Loss weights
    consis_weight: float = 50.0
    pse_weight: float = 1.0
    seg_weight: float = 1.0  # the supervised step's; the AMOS supervised CLI uses 0.5

    # Optimizer (constant across the reference)
    momentum: float = 0.9
    weight_decay: float = 1e-4
    poly_power: float = 0.9

    # Cadence: validation every `val_interval` steps, metrics logged every
    # `log_interval` steps (each log reads the metrics back from the card)
    val_interval: int = 200
    log_interval: int = 1
    # the full train state every `checkpoint_interval` steps (0: never),
    # the newest `keep_checkpoints` step files kept (0: all); `fit` always
    # ends with `state_last.pt`
    checkpoint_interval: int = 0
    keep_checkpoints: int = 3

    # 'float32' (TF32 off, parity) or 'bfloat16' (forward under autocast)
    precision: str = "float32"
    remat: bool = False  # recompute the backbone's blocks in the backward
    # the ICL models' two labeled-mode sspa calls as one batched call
    # (per-branch BatchNorm stats and labeled-only query means kept)
    fuse_icl_pair: bool = False
    # train-state storage: 'float32', or 'bfloat16' (bf16 parameters and
    # momentum, the update in f32, stochastically rounded stores:
    # `train/optim.py`)
    state_dtype: str = "float32"
    # `scan_steps` steps per group, each group never crossing a validation,
    # checkpoint or end boundary; on the card a group is that many replays
    # of one captured CUDA graph of the step (1: eager steps). Up to
    # `dispatch_depth` groups stay in flight before the host waits for the
    # oldest; a group's metrics are read only when it leaves that window
    scan_steps: int = 1
    dispatch_depth: int = 1
    # gradient accumulation (optax.MultiSteps' contract, `train/optim.py`):
    # each update applies the mean gradient of `grad_accum` micro-steps, and
    # the poly LR counts updates; 1 = off
    grad_accum: int = 1
    # count the step's matmul and convolution FLOPs once, at its first eager
    # run (`utils/flops.py`), and log GFLOP/step and the run's end-to-end
    # analytic TFLOP/s
    log_flops: bool = True
    # the 2D augmentations (rot90/flip, +-20 degree rotate, order-0 zoom) on
    # the device inside the step, on raw slices or a device-resident bank
    # (`data/device_augment.py`, `data/device_bank.py`)
    device_augment: bool = False
    feature_size: int = 48
    experiments_dir: str = "../experiments"
    # extra net_factory kwargs (the Swin CLIs' --cfg: {"swin_cfg": SwinConfig})
    model_kwargs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.labeled_bs == -1:
            self.labeled_bs = min(8, self.batch_size)
        if not 0 < self.labeled_bs <= self.batch_size:
            raise ValueError(
                f"labeled_bs={self.labeled_bs} must be in [1, batch_size={self.batch_size}]: "
                f"shrinking --batch_size requires shrinking --labeled_bs with it")
        if self.precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision {self.precision!r}: want float32 or bfloat16")
        if self.scan_steps < 1 or self.grad_accum < 1 or self.dispatch_depth < 1:
            raise ValueError(
                f"scan_steps ({self.scan_steps}), grad_accum ({self.grad_accum}) and "
                f"dispatch_depth ({self.dispatch_depth}) must be >= 1")
        if self.state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"state_dtype: {self.state_dtype!r}")
        if self.state_dtype == "bfloat16" and self.grad_accum > 1:
            # the JAX package's rule: optax.MultiSteps would accumulate in the
            # bf16 parameter dtype
            raise ValueError("state_dtype='bfloat16' requires grad_accum=1")

    @property
    def snapshot_path(self) -> str:
        """Reference layout: ../experiments/{exp}_{labeled_num}_labeled/
        {model}_exp_{num_tries}."""
        return (f"{self.experiments_dir}/{self.exp}_{self.labeled_num}_labeled/"
                f"{self.model}_exp_{self.num_tries}")

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def acdc_icl_config(**overrides) -> ExperimentConfig:
    """The flagship's config: U-Net-ICL on ACDC at the JAX CLI's defaults
    (`icl_tpu/config.py:164`), with `overrides`."""
    return ExperimentConfig(**{**ACDC_ICL_DEFAULTS, **overrides})


def acdc_supervised_config(**overrides) -> ExperimentConfig:
    """The fully supervised U-Net on ACDC (`icl_tpu/config.py:168`): no
    consistency or pseudo-label weight, with `overrides`."""
    return acdc_icl_config(exp="ACDC/Fully_Supervised", model="unet", labeled_num=7,
                           consis_weight=0.0, pse_weight=0.0).replace(**overrides)
