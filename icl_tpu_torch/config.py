"""The `ExperimentConfig` fields the eval CLI reads (counterpart of
`icl_tpu/config.py`)."""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class ExperimentConfig:
    root_path: str = "../data/BraTS2019"
    exp: str = "BraTS2019/Inherent_Consistent_Learning"
    model: str = "swinunetr_icl"
    num_classes: int = 2
    patch_size: Sequence[int] = (96, 96, 96)
    labeled_num: int = 25
    num_tries: str = "1"
    experiments_dir: str = "../experiments"

    @property
    def snapshot_path(self) -> str:
        """Reference layout: ../experiments/{exp}_{labeled_num}_labeled/
        {model}_exp_{num_tries}."""
        return (f"{self.experiments_dir}/{self.exp}_{self.labeled_num}_labeled/"
                f"{self.model}_exp_{self.num_tries}")
