"""icl_tpu_torch's tensor parallelism (`parallel/mesh.py`, `parallel/tensor.py`)
against the JAX package's model axis, on the CPU: the rule table against
`DEFAULT_PARAM_RULES` on the four ICL models, each parallel module at tp=2
in two gloo processes against the whole module (f64, 1e-10), the bf16
update of a shard against the slice of the whole leaf's (bit for bit),
`create_mesh`'s refusals, `Trainer.fit` over two tensor-parallel ranks
against one process (its FLOP line, its saves in the one-process layout,
restores both ways and on) and with validations that part across the
ranks, and the JAX package's bf16 train state under `shard_state`.

The workers (`_torch_tp.py`) import only torch, numpy and `icl_tpu_torch`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.models.swin2d import SwinConfig as JaxSwinConfig
from icl_tpu.parallel.mesh import create_mesh as jax_create_mesh
from icl_tpu.parallel.mesh import param_shardings as jax_param_shardings
from icl_tpu.utils.torch_import import (export_icl_heads, export_icl_unet2d, export_icl_unet3d,
                                        export_swinunet2d, export_swinunetr)

import _torch_tp
from _torch_dp import run_ranks
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.pipeline import acdc_train_batches
from icl_tpu_torch.data.synth import synthetic_acdc
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.models.swin2d import SwinConfig
from icl_tpu_torch.ops.sgd_bf16 import sgd_bf16_plain
from icl_tpu_torch.parallel.mesh import Mesh, create_mesh, param_shardings, replicated_layers
from icl_tpu_torch.parallel.tensor import Split
from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator
from icl_tpu_torch.utils import checkpoint as ckpt

MODEL_AXIS = 2
SWIN_2D = dict(img_size=64, window_size=4, embed_dim=12)
# the attention layers whose heads do not divide by 2: Swin-T's 3-head stage
# 1, in Swin-UNet's encoder and its last decoder stage, and SwinUNETR's
REPLICATED_AT_2 = {
    "icl_unet": {}, "unet_3D_icl": {},
    "icl_swinunet": {f"swin_unet.{stage}.blocks.{b}.attn": "3 heads"
                     for stage in ("layers.0", "layers_up.3") for b in (0, 1)},
    "swinunetr_icl": {f"swinViT.layers1.0.blocks.{b}.attn": "3 heads" for b in (0, 1)},
}


def _jax_params(kind: str):
    """The JAX model's parameter shapes and the port's model of the same
    configuration (small sizes)."""
    if kind == "icl_unet":
        jm, x = jax_net_factory("icl_unet", 1, 4, patch_size=32), jnp.zeros((2, 32, 32, 1))
        pm = net_factory("icl_unet", 1, 4, device="cpu", patch_size=32)
    elif kind == "unet_3D_icl":
        jm, x = jax_net_factory("unet_3D_icl", 1, 2, patch_size=32), jnp.zeros((2, 32, 32, 32, 1))
        pm = net_factory("unet_3D_icl", 1, 2, device="cpu", patch_size=32)
    elif kind == "icl_swinunet":
        jm = jax_net_factory("icl_swinunet", 1, 4, swin_cfg=JaxSwinConfig(**SWIN_2D))
        x = jnp.zeros((2, 64, 64, 1))
        pm = net_factory("icl_swinunet", 1, 4, device="cpu", swin_cfg=SwinConfig(**SWIN_2D))
    else:
        jm = jax_net_factory("swinunetr_icl", 1, 2, patch_size=32, feature_size=12)
        x = jnp.zeros((2, 32, 32, 32, 1))
        pm = net_factory("swinunetr_icl", 1, 2, device="cpu", feature_size=12, patch_size=32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, x, train=True))
    return shapes, pm


def _export(kind: str, params, batch_stats) -> dict:
    """The JAX tree in the port's key layout, through `torch_import`'s
    exports."""
    if kind == "icl_unet":
        return export_icl_unet2d(params, batch_stats)
    if kind == "unet_3D_icl":
        return export_icl_unet3d(params, batch_stats)
    if kind == "icl_swinunet":
        out = {f"swin_unet.{k}": v for k, v in export_swinunet2d(
            params["swin_unet"], img_size=SWIN_2D["img_size"], window=SWIN_2D["window_size"]).items()}
    else:
        out = dict(export_swinunetr(params["backbone"]))
    for k, v in export_icl_heads(params, batch_stats).items():
        out[k.replace(".guided_Q", ".guide_Q") if kind == "swinunetr_icl" else k] = v
    return out


@pytest.mark.parametrize("kind", sorted(REPLICATED_AT_2))
def test_rule_table_shards_the_leaves_of_default_param_rules(kind):
    """Every leaf filled with 1.0 where `DEFAULT_PARAM_RULES` (over a 4 x 2
    mesh) split its output axis, 2.0 where its input axis, 0.0 where it
    replicate it, and exported: the port splits exactly the 1.0 keys on
    dim 0 and the 2.0 keys on dim 1, but for the attention layers whose
    heads do not divide, which stay replicated and are listed."""
    shapes, port_model = _jax_params(kind)
    specs = jax_param_shardings(shapes["params"], jax_create_mesh(data=4, model=MODEL_AXIS))

    def fill(leaf, sharding):
        spec = tuple(sharding.spec)
        value = 1.0 if spec and spec[-1] == "model" else 2.0 if "model" in spec else 0.0
        return np.full(leaf.shape, value, np.float32)

    params = jax.tree_util.tree_map(fill, shapes["params"], specs)
    stats = jax.tree_util.tree_map(lambda leaf: np.zeros(leaf.shape, np.float32),
                                   shapes.get("batch_stats", {}))
    exported = _export(kind, params, stats)
    replicated = replicated_layers(port_model, MODEL_AXIS)
    assert replicated == REPLICATED_AT_2[kind]
    mesh = Mesh(None, 0, 4, torch.device("cpu"), None, 0, MODEL_AXIS, 0, 8)
    got = {k: d for k, d in param_shardings(port_model, mesh).items() if d is not None}
    names = dict(port_model.named_parameters())
    want = {}
    for k, v in exported.items():
        if k not in names:
            continue
        value = float(np.unique(np.asarray(v))[0])
        assert np.all(np.asarray(v) == value), k
        if value and not any(k.startswith(layer + ".") for layer in replicated):
            want[k] = 0 if value == 1.0 else 1
    assert set(names) <= set(exported), sorted(set(names) - set(exported))[:5]
    assert got == want
    assert len(want) > (20 if kind.startswith("icl_unet") else 40)


def _case_inputs():
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    return {
        "class_decoder_2d": {"inputs": [t(2, 4, 32), t(2, 16, 32)], "grads": [t(2, 4, 32), t(2, 4, 4, 16)]},
        "class_decoder_3d": {"inputs": [t(2, 3, 48), t(2, 64, 48)], "grads": [t(2, 3, 48), t(2, 3, 6, 64)]},
        "swin2d_none": {"inputs": [t(2, 8, 8, 32)], "grads": [t(2, 8, 8, 32)]},
        "swin2d_mask": {"inputs": [t(2, 8, 8, 32)], "grads": [t(2, 8, 8, 32)]},
        "swin2d_three_heads": {"inputs": [t(2, 8, 8, 24)], "grads": [t(2, 8, 8, 24)]},
        "swin3d_region": {"inputs": [t(2, 8, 8, 8, 24)], "grads": [t(2, 8, 8, 8, 24)]},
        "encoder10": {"inputs": [t(2, 16, 4, 4, 4)], "grads": [t(2, 16, 4, 4, 4)]},
    }


@pytest.fixture(scope="module")
def modules_at_tp2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_modules")
    return run_ranks(tmp, "modules", _case_inputs(), world=2, script=_torch_tp.__file__)


SHARDED = {
    "class_decoder_2d": ["attn.fc_kv.bias", "attn.fc_kv.weight", "attn.fc_q.bias", "attn.fc_q.weight",
                         "attn.proj.weight", "mlp.fc1.bias", "mlp.fc1.weight", "mlp.fc2.weight",
                         "mlp2.fc1.bias", "mlp2.fc1.weight", "mlp2.fc2.weight"],
    "swin2d": ["attn.proj.weight", "attn.qkv.bias", "attn.qkv.weight", "mlp.fc1.bias",
               "mlp.fc1.weight", "mlp.fc2.weight"],
    "swin2d_three_heads": ["mlp.fc1.bias", "mlp.fc1.weight", "mlp.fc2.weight"],
    "swin3d_region": ["attn.proj.weight", "attn.qkv.bias", "attn.qkv.weight", "mlp.linear1.bias",
                      "mlp.linear1.weight", "mlp.linear2.weight"],
    "encoder10": ["encoder10.layer.conv1.conv.weight", "encoder10.layer.conv2.conv.weight"],
}


@pytest.mark.parametrize("kind", sorted(_case_inputs()))
def test_parallel_module_at_tp2_equals_the_whole_module(modules_at_tp2, kind):
    """Forward output, input gradients and every parameter gradient (a
    shard's against its slice of the whole gradient, the replicated bias
    tables' summed over the model group) within 1e-10, on both ranks; the
    3-head block keeps its attention replicated."""
    want = SHARDED.get(kind, SHARDED.get(kind.rsplit("_", 1)[0]))
    if kind.startswith("class_decoder"):
        want = SHARDED["class_decoder_2d"]
    for rank in modules_at_tp2:
        got = rank[kind]
        assert got["sharded"] == want
        assert got["replicated"] == ({"attn": "3 heads"} if kind == "swin2d_three_heads" else {})
        assert got["scale"] > 0.01
        assert got["out_err"] <= 1e-10 and got["in_grad_err"] <= 1e-10, got
        assert max(got["param_errs"].values()) <= 1e-10, got["param_errs"]


@pytest.mark.parametrize("split", [Split(0, 24, 1, 1, 2), Split(0, 24, 3, 0, 2), Split(0, 24, 3, 1, 2),
                                   Split(1, 40, 1, 1, 2), Split(1, 12, 1, 1, 4), Split(0, 36, 2, 1, 2)],
                         ids=["rows", "qkv_rank0", "qkv_rank1", "columns", "columns_odd", "fc_kv_rank1"])
def test_sr_update_of_a_shard_is_the_slice_of_the_whole_update(split):
    """The bf16 update's plain version on a shard, its dithers drawn at the
    whole leaf's indices (one call per contiguous run, as `PolySGD` makes
    them), equals the shard of the whole leaf's update bit for bit."""
    from icl_tpu_torch.train.optim import shard_runs

    rng = np.random.default_rng(3)
    shape = (split.full, 12) if split.dim == 0 else (10, split.full, 3)
    p, g, buf = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
                 for _ in range(3))
    lr, count = torch.tensor(0.01), torch.tensor(7)
    shard = tuple(split.take(t).clone() for t in (p, g, buf))
    sgd_bf16_plain(p, g, buf, lr, count, 0.9, 1e-4, 11, 5)
    for run, offset, cols, stride in shard_runs(split, shard):
        sgd_bf16_plain(*run, lr, count, 0.9, 1e-4, 11, 5, offset, cols, stride)
    assert torch.equal(shard[0].view(torch.int16), split.take(p).view(torch.int16))
    assert torch.equal(shard[2].view(torch.int16), split.take(buf).view(torch.int16))


def test_create_mesh_refuses_a_grid_that_is_not_the_processes():
    """One process: model 2 does not divide it, data 2 x model 1 is not it;
    data -1 x model 1 is the one-process mesh."""
    with pytest.raises(ValueError, match="does not divide the 1 processes"):
        create_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="data=2 x model=1 is not the 1 processes"):
        create_mesh(data=2, device="cpu")
    mesh = create_mesh(data=-1, model=1, device="cpu")
    assert (mesh.size, mesh.model_size, mesh.model_group, mesh.process_count) == (1, 1, None, 1)


def test_jax_bf16_state_keeps_its_momentum_replicated_under_shard_state():
    """A fault of the JAX package, logged in ROADMAP.md: `shard_state`
    shards momentum only inside an `optax.TraceState`, so the bf16 state's
    `SGDBf16State.trace` stays replicated, `mlp2`'s too, while its
    parameter is split. The port's momentum lives with the shard."""
    from icl_tpu.parallel.mesh import shard_state
    from icl_tpu.train.optim import make_sgd
    from icl_tpu.train.state import TrainState

    shapes, _ = _jax_params("icl_unet")
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, jnp.bfloat16), shapes["params"])
    state = TrainState.create(params, {}, make_sgd(0.01, 10, state_dtype="bfloat16"))
    sharded = shard_state(state, jax_create_mesh(data=4, model=MODEL_AXIS))
    kernel = sharded.params["sspa"]["class_decoder0"]["mlp2"]["fc1"]["Dense_0"]["kernel"]
    traces = [leaf for leaf in jax.tree_util.tree_leaves(sharded.opt_state)
              if getattr(leaf, "shape", None) == kernel.shape]
    assert tuple(kernel.sharding.spec) == (None, "model")
    assert traces and all(tuple(t.sharding.spec) == () for t in traces)


BATCH, LABELED, PATCH = 4, 2, 16
FIT_CFG = dict(model="icl_unet", num_classes=4, batch_size=BATCH, labeled_bs=LABELED,
               patch_size=(PATCH, PATCH), max_iterations=4, val_interval=2, checkpoint_interval=2,
               seed=3, exp="ACDC/ICL", labeled_num=3, num_tries="tp",
               model_kwargs={"zero_stochastic": True})


def _fit(trainer, batches, volumes):
    return trainer.fit(iter(batches), evaluate=acdc_evaluator(volumes, 4, (PATCH, PATCH), "cpu"))


@pytest.fixture(scope="module")
def fit_at_tp2(tmp_path_factory):
    """The one-process run (2 steps, a validation and the step-2 save),
    then the same over two tensor-parallel ranks and their two restores."""
    tmp = tmp_path_factory.mktemp("tp_fit")
    slices, volumes = synthetic_acdc(12, 2, 40, 2, 4, seed=2)
    batches = [b for _, b in zip(range(4), acdc_train_batches(slices, 5, BATCH, LABELED,
                                                              (PATCH, PATCH), seed=3))]
    one = Trainer(ExperimentConfig(**FIT_CFG, experiments_dir=str(tmp / "one")), device="cpu")
    one_result = _fit(one, batches[:2], volumes)
    job = {"cfg": FIT_CFG, "dir": str(tmp / "tp"), "one_process_dir": str(tmp / "one"),
           "batches": batches, "volumes": volumes}
    ranks = run_ranks(tmp, "trainer", job, world=2, script=_torch_tp.__file__)
    return tmp, batches, volumes, one, one_result, ranks


def _snapshot(tmp, where: str, tries: str = "tp") -> str:
    return ExperimentConfig(**dict(FIT_CFG, num_tries=tries), experiments_dir=str(tmp / where)).snapshot_path


def _within_step_tolerance(got: dict, want: dict, what: str):
    for k, v in want.items():
        if not torch.is_floating_point(v):
            assert torch.equal(got[k], v), f"{what} {k}"
            continue
        err = float((got[k].double() - v.double()).abs().max())
        assert err <= 1e-3 * float(v.double().abs().max()) + 1e-6, f"{what} {k}: {err:.3e}"


def test_fit_over_two_tp_ranks_matches_one_process_and_writes_its_layout(fit_at_tp2):
    """The tp=2 fit's validation, FLOP line, loss lines and saved state
    (the one-process layout: the keys and shapes of the one-process save,
    momentum included) against the one-process fit's; only rank 0 logs."""
    tmp, _, _, one, one_result, (r0, r1) = fit_at_tp2
    assert r0["fit"]["step_flops"] == r1["fit"]["step_flops"] == one_result["step_flops"]
    assert len(r0["sharded"]) == 66
    for r in (r0, r1):
        assert [v["iteration"] for v in r["fit"]["vals"]] == [2]
        np.testing.assert_allclose(r["fit"]["vals"][0]["mean_dice"], one_result["vals"][0]["mean_dice"],
                                   atol=1e-3)
        for row, want in zip(r["fit"]["log"], one_result["log"]):
            np.testing.assert_allclose(row["loss"], want["loss"], rtol=1e-4)
    assert r0["fit"]["best_path"] and r1["fit"]["saves"] == []
    with open(_snapshot(tmp, "tp") + "/log.txt") as f:
        assert f.read().count("iteration 2 : mean_dice") == 1
    tp_state = ckpt.load_train_state(_snapshot(tmp, "tp"), "step_00000002")
    one_state = ckpt.load_train_state(_snapshot(tmp, "one"), "step_00000002")
    assert set(tp_state["model"]) == set(one_state["model"])
    for k, v in one_state["model"].items():
        assert tp_state["model"][k].shape == v.shape, k
    _within_step_tolerance(tp_state["model"], one_state["model"], "state")
    # momentum against the state's largest: the biases before a BatchNorm
    # have cancelling gradients, f32 rounding noise at their own scale
    want = [s["momentum_buffer"] for s in one_state["optimizer"]["state"].values()]
    scale = max(float(m.abs().max()) for m in want)
    for i, m in enumerate(want):
        got = tp_state["optimizer"]["state"][i]["momentum_buffer"]
        assert got.shape == m.shape and float((got - m).abs().max()) <= 1e-3 * scale, i
    best = torch.load(_snapshot(tmp, "tp") + "/model/model_best.pth", weights_only=True)
    net_factory("icl_unet", 1, 4, device="cpu", inference=True).load_state_dict(best, strict=True)


def test_fit_at_tp2_takes_one_branch_when_the_ranks_validations_part(tmp_path):
    """Model rank 0's validation decides for its group: rank 0 a hair above
    the best so far, rank 1 a hair below it, and the fit still ends, both
    ranks with rank 0's validations and the best model saved twice."""
    slices, _ = synthetic_acdc(12, 2, 40, 2, 4, seed=2)
    batches = [b for _, b in zip(range(2), acdc_train_batches(slices, 5, BATCH, LABELED,
                                                              (PATCH, PATCH), seed=3))]
    job = {"cfg": dict(FIT_CFG, max_iterations=2, val_interval=1, checkpoint_interval=0,
                       num_tries="tie"),
           "dir": str(tmp_path / "tie"), "batches": batches,
           "dice": [[0.5, 0.5 + 1e-9], [0.5, 0.5 - 1e-9]]}
    r0, r1 = run_ranks(tmp_path, "tie", job, world=2, script=_torch_tp.__file__)
    assert r0["vals"] == r1["vals"] == [0.5, 0.5 + 1e-9]
    assert r0["best"] == r1["best"] == 0.5 + 1e-9
    assert r0["best_path"] == r1["best_path"] and r0["best_path"]


def test_a_tp2_save_restores_at_tp1_and_a_tp1_save_at_tp2(fit_at_tp2):
    """Restores both ways take the saved state bit for bit, and go on: the
    one-process restore of the tp=2 save against the tp=2 ranks' own
    continuation, and the tp=2 restore of the one-process save against the
    one-process continuation, each within the step tolerance after 2 more
    steps."""
    tmp, batches, volumes, _, _, (r0, _) = fit_at_tp2
    tp_saved = ckpt.load_train_state(_snapshot(tmp, "tp"), "step_00000002")
    one_saved = ckpt.load_train_state(_snapshot(tmp, "one"), "step_00000002")
    at_one = Trainer(ExperimentConfig(**dict(FIT_CFG, num_tries="from_tp"),
                                      experiments_dir=str(tmp / "one")), device="cpu")
    at_one.load_train_state(tp_saved)
    for k, v in tp_saved["model"].items():
        assert torch.equal(at_one.model.state_dict()[k], v), k
    _fit(at_one, batches[2:], volumes)
    cont_one = Trainer(ExperimentConfig(**dict(FIT_CFG, num_tries="cont"),
                                        experiments_dir=str(tmp / "one")), device="cpu")
    cont_one.load_train_state(one_saved)
    _fit(cont_one, batches[2:], volumes)
    for name, want_trainer in (("own", at_one), ("one_process", cont_one)):
        assert r0[f"resume_{name}"]["iteration"] == 4
        got = ckpt.load_train_state(_snapshot(tmp, "tp", f"tp_{name}"), "last")
        _within_step_tolerance(got["model"], want_trainer.model.state_dict(), f"resume {name}")
    for state in (tp_saved, one_saved):
        assert state["iteration"] == 2 and state["count"] == 2
