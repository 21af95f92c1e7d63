"""The bf16 train state with recompute (`state_dtype="bfloat16"`,
`remat=True`), which the JAX Trainer runs with block-level remat for
SwinUNETR (icl_tpu/train/trainer.py:64-90): the port's step holds the
upcast f32 copies of its bf16 parameters across the forward and the
backward (`train/steps.upcast_parameters`), so that a recomputed block
(`models/layers.call_remat`) reads the copies the first forward read.

- Through `Trainer`, SwinUNETR-ICL (fs12, window 7, 32^3, batch 4 of which
  2 labeled) and U-Net-ICL 3D (16^3) with a bf16 state: a step with remat
  against one without, from the same weights and batch, bit for bit
  (parameters, buffers, momentum, metrics). The recompute runs the
  same arithmetic on the same inputs and torch's checkpoint restores the
  RNG state around it, so nothing may differ. The supervised SwinUNETR
  the same way.
- SwinUNETR-ICL's bf16-state step with remat against the JAX package's
  (its model with `remat=True`, `make_sgd(state_dtype="bfloat16")`) from
  the same bf16 weights, by the rule of
  `test_torch_train_bf16.py::test_bf16_state_icl_step_matches_jax`: each
  parameter within 2 bf16 ulps of JAX's at the tensor's scale, the loss
  terms 1e-4 relative; the 12 attention-conv BatchNorms of the ICL heads
  are left out for the reason that test gives (JAX computes the heads'
  labeled query stream from the bf16 `guided_Q` in bf16, the port in f32).
  The backbone has no BatchNorm. For the same reason the two terms of the
  `sspa` maps, `loss_aux` and `loss_aux_consis` (and the total that sums
  them), are held to 1e-3: the bf16 stream moves them by 2.7e-5 and
  4.7e-4 relative here (1.1e-4 on the total), where the U-Net's smaller
  heads stay within 1e-4; the terms of the backbone's logits and of the
  `uscl` maps stay within 1e-4 (2e-6 seen).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.train.optim import make_sgd
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_icl_step as jax_make_icl_step

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import METRIC_KEYS, make_icl_step
from icl_tpu_torch.train.trainer import Trainer
from icl_tpu_torch.utils.convert import swinunetr_icl_state_dict_from_jax
from test_torch_icl import FS, LABELED_BS, NCLS, PATCH, batch, draw_tree, no_drop_path, no_port_drop_path  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

BASE_LR, MAX_IT, CONSIS = 0.01, 10, 10.0
# model -> (patch side, ExperimentConfig fields)
MODELS = {"swinunetr_icl": (PATCH, dict(feature_size=FS, consis_weight=CONSIS)),
          "unet_3D_icl": (16, dict(consis_weight=CONSIS)),
          "swinunetr": (PATCH, dict(feature_size=FS))}


def _trainer(model: str, remat: bool) -> Trainer:
    side, kw = MODELS[model]
    cfg = ExperimentConfig(model=model, num_classes=NCLS, batch_size=2 * LABELED_BS,
                           labeled_bs=LABELED_BS if model.endswith("icl") else 2 * LABELED_BS,
                           patch_size=(side,) * 3, max_iterations=MAX_IT, base_lr=BASE_LR,
                           state_dtype="bfloat16", remat=remat, seed=3, **kw)
    return Trainer(cfg, device="cpu")


def _state(trainer: Trainer) -> dict:
    out = {f"model.{k}": v.clone() for k, v in trainer.model.state_dict().items()}
    out.update({f"momentum.{i}": b.clone() for i, b in enumerate(trainer.optimizer.momentum_buffers)})
    return out


@pytest.mark.parametrize("model", list(MODELS))
def test_bf16_state_steps_with_remat_equal_the_steps_without(model):
    side, _ = MODELS[model]
    rng = np.random.default_rng(4)
    batches = [{"image": torch.from_numpy(rng.standard_normal((4, 1, side, side, side)).astype(np.float32)),
                "label": torch.from_numpy(rng.integers(0, NCLS, (4, side, side, side))).long()}
               for _ in range(1)]
    runs = {}
    for remat in (False, True):
        trainer = _trainer(model, remat)
        assert next(trainer.model.parameters()).dtype == torch.bfloat16
        metrics = []
        for b in batches:
            torch.manual_seed(0)  # the heads' drop path draws the same masks in both runs
            metrics.append(trainer.train_step(trainer.to_device(b)).tolist())
        runs[remat] = (metrics, _state(trainer))
    assert runs[True][0] == runs[False][0]
    (_, plain), (_, remat) = runs[False], runs[True]
    assert plain.keys() == remat.keys()
    differ = [k for k in plain if not torch.equal(plain[k], remat[k])]
    assert not differ, differ
    assert any(v.dtype == torch.bfloat16 for k, v in remat.items() if k.startswith("momentum."))


def test_bf16_state_swinunetr_icl_step_with_remat_matches_jax(no_drop_path):
    jax_model = jax_net_factory("swinunetr_icl", 1, NCLS, patch_size=PATCH, feature_size=FS, remat=True)
    zeros = jnp.zeros((LABELED_BS, PATCH, PATCH, PATCH, 1))
    shapes = jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, zeros, zeros, train=True))
    params = jax.tree.map(lambda p: jnp.asarray(p, jnp.bfloat16), draw_tree(shapes["params"], 5))
    bs = draw_tree(shapes["batch_stats"], 6)
    x, xt, y = batch(9)
    tx = make_sgd(BASE_LR, MAX_IT, state_dtype="bfloat16")
    step = jax_make_icl_step(jax_model, tx, NCLS, LABELED_BS, (PATCH,) * 3, CONSIS)
    new_state, met_j = jax.device_get(jax.jit(step)(TrainState.create(params, bs, tx),
                                                   {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                                                   jax.random.PRNGKey(0)))
    f32 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    old = swinunetr_icl_state_dict_from_jax(f32(params), bs)
    new = swinunetr_icl_state_dict_from_jax(f32(new_state.params), new_state.batch_stats)

    model = net_factory("swinunetr_icl", 1, NCLS, device="cpu", feature_size=FS, patch_size=PATCH,
                        remat=True)
    model.load_state_dict(old, strict=True)
    no_port_drop_path(model).train()
    for p in model.parameters():
        p.data = p.data.to(torch.bfloat16)
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT, state_dtype="bfloat16")
    met_p = make_icl_step(model, opt, NCLS, LABELED_BS, (PATCH,) * 3, CONSIS)(
        {"image": torch.from_numpy(xt), "label": torch.from_numpy(y).long()})

    for k in METRIC_KEYS:
        rtol = 1e-3 if k in ("loss", "loss_aux", "loss_aux_consis") else 1e-4
        np.testing.assert_allclose(float(met_p[k]), float(met_j[k]), rtol=rtol, err_msg=k)
    apart = {}
    for (name, p), buf in zip(model.named_parameters(), opt.momentum_buffers):
        assert p.dtype == buf.dtype == torch.bfloat16, name
        got, want = p.detach().float(), new[name].float()
        scale = max(float(got.abs().max()), float(want.abs().max()))
        ulp = float(np.spacing(np.float32(scale))) * 2 ** 16  # bf16's ulp at the tensor's scale
        apart[name] = float((got - want).abs().max()) / ulp
    assert max(apart.values()) <= 2, {k: v for k, v in apart.items() if v > 2}
    assert any(apart.values())  # the dithers are the two packages' own
    norms = [k[:-len(".running_mean")] for k in new if k.endswith(".running_mean")]
    assert len(norms) == 12 and all(".attn_convs0." in k for k in norms)
