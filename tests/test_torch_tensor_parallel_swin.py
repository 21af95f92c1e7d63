"""SwinUNETR-ICL over tp=2 (2 gloo processes; feature size 12, window 4,
32^3, batch 4 of which 2 labeled) against the JAX package's single-device
step in f64, by the checks of `test_torch_tensor_parallel_steps.py`: its
stage 1 (3 heads) stays replicated, stages 2-4 run on their heads; the
same with the fused `sspa` pair, against the same JAX step (the fused
pair computes what the two calls do). A file of its own, so that xdist's
`--dist loadfile` runs it beside the dp2 x tp2 flagship.
"""
import pytest

import _torch_tp
from _torch_dp import run_ranks
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_tensor_parallel_steps import _check_against_jax, _reference


@pytest.fixture(scope="module")
def swin_tp2(tmp_path_factory):
    case = _reference("swinunetr_icl")[0]
    job = {"model": 2, "cases": {"swinunetr_icl": case, "swinunetr_icl_fused_pair": dict(case, fuse=True)}}
    return run_ranks(tmp_path_factory.mktemp("swin_tp2"), "steps", job, world=2,
                     script=_torch_tp.__file__)


def test_tp2_swinunetr_icl_step_matches_the_jax_single_device_step(swin_tp2):
    sharded = swin_tp2[0]["swinunetr_icl"]["sharded"]
    assert "swinViT.layers1.0.blocks.0.attn.qkv.weight" not in sharded
    assert "swinViT.layers1.0.blocks.0.mlp.linear1.weight" in sharded
    for stage in (2, 3, 4):
        assert f"swinViT.layers{stage}.0.blocks.1.attn.qkv.weight" in sharded
    assert "encoder10.layer.conv1.conv.weight" in sharded
    _check_against_jax("swinunetr_icl", swin_tp2)


def test_tp2_swinunetr_icl_fused_pair_step_matches_the_jax_single_device_step(swin_tp2):
    """The fused pair runs under a model axis as the U-Net's does: the
    heads' `mlp2` and query attention split by the rule table, the labeled
    and consistency rows in one call."""
    assert swin_tp2[0]["swinunetr_icl_fused_pair"]["sharded"] == swin_tp2[0]["swinunetr_icl"]["sharded"]
    _check_against_jax("swinunetr_icl_fused_pair", swin_tp2, reference="swinunetr_icl")
