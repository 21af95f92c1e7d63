"""icl_tpu_torch's bf16 train state against the JAX package's: the
flagship's ICL step with bf16 parameters and momentum (the JAX test's
`icl_unet` configuration, `tests/test_optim_bf16.py:140-166`, at patch 32)
against the JAX bf16-state step from the same weights; the supervised
U-Net's bf16 state, which trains, checkpoints at about half the f32
state's bytes and refuses an f32 state; and a resumed fast-configuration
run (bf16 state, device bank, step groups), 2 + 2 steps against 4, bit
for bit.

Tolerances. Loss terms: 1e-4 relative, the f32 step's (both sides run the
forward in f32 on the same bf16 weights, flax by promotion and the port
on upcast copies). Each parameter tensor: within 2 bf16 ulps of JAX's at
the tensor's scale (the ulp of its largest magnitude). Both sides round
the new f32 values stochastically to one of their two bf16 neighbours with
dithers of their own (JAX's come from rng_bit_generator): one ulp apart;
and the f32 values come from gradients computed by two frameworks in f32,
whose rounding differs most where the gradients of the layers that feed a
train-mode BatchNorm cancel (`test_torch_train_unet2d.py` runs its
f32-state step in f64 for that reason; here the parameters are bf16):
one more ulp. The rule is at the tensor's scale because an element near
zero, which the update may carry across zero, has ulps far below the
error the gradients allow it. For the same reason the momentum, the
first step's gradient itself, is not compared (up to 33% of its largest
magnitude apart in the BatchNorm-fed layers); `test_torch_optim_bf16.py`
holds the update from given gradients. BatchNorm running stats as
`test_torch_unet2d.py`: 1e-5 after flax's n / (n - 1) factor, except the
ICL heads' attention-conv BatchNorms (`attn_convs*.bn_depth`,
`bn_point`), which are not compared: flax promotes a bf16 weight to f32
only where an f32 operand joins it, and the heads' labeled query stream
starts from the bf16 `guided_Q` parameter, so JAX computes its first
projection and attention in bf16 where the port computes in f32; those
BatchNorms' running means then part by up to 3.1e-4 and their variances
by up to 3.8e-3 (ROADMAP.md section 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icl_tpu.train.optim import make_sgd
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_icl_step as jax_make_icl_step

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import METRIC_KEYS, make_icl_step
from icl_tpu_torch.train.trainer import Trainer
from icl_tpu_torch.utils.convert import icl_unet2d_state_dict_from_jax
from icl_tpu.models.unet2d_icl import UNetICL as JaxUNetICL
from test_torch_icl import draw_tree
from test_torch_unet2d import LABELED_BS, NCLS, assert_running_stats, bn_batch_sizes
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

BASE_LR, MAX_IT, CONSIS = 0.01, 50, 50.0
PATCH = 32  # the JAX test's icl_unet patch (ICL scales 4^2, 8^2, 16^2)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_bf16_state_icl_step_matches_jax():
    jax_model = JaxUNetICL(1, NCLS, patch_size=PATCH, zero_stochastic=True)
    zeros = jnp.zeros((LABELED_BS, PATCH, PATCH, 1))
    shapes = jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, zeros, zeros, train=True))
    params = jax.tree.map(lambda p: jnp.asarray(p, jnp.bfloat16), draw_tree(shapes["params"], 5))
    bs = draw_tree(shapes["batch_stats"], 6)
    x = np.random.default_rng(6).standard_normal((2 * LABELED_BS, PATCH, PATCH, 1)).astype(np.float32)
    xt = np.moveaxis(x, -1, 1).copy()
    y = np.random.default_rng(7).integers(0, NCLS, (2 * LABELED_BS, PATCH, PATCH)).astype(np.int32)
    tx = make_sgd(BASE_LR, MAX_IT, state_dtype="bfloat16")
    step = jax_make_icl_step(jax_model, tx, NCLS, LABELED_BS, (PATCH, PATCH), CONSIS)
    new_state, met_j = jax.device_get(jax.jit(step)(TrainState.create(params, bs, tx),
                                                   {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                                                   jax.random.PRNGKey(0)))
    assert jax.tree.leaves(new_state.params)[0].dtype == jnp.bfloat16
    # bf16 values carried through f32, exactly
    old = icl_unet2d_state_dict_from_jax(_f32(params), bs)
    new = icl_unet2d_state_dict_from_jax(_f32(new_state.params), new_state.batch_stats)
    assert jax.tree.leaves(new_state.opt_state.trace)[0].dtype == jnp.bfloat16

    model = net_factory("icl_unet", 1, NCLS, device="cpu", patch_size=PATCH, zero_stochastic=True)
    model.load_state_dict(old, strict=True)
    for p in model.parameters():
        p.data = p.data.to(torch.bfloat16)
    model.train()
    sizes = bn_batch_sizes(model)
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT, state_dtype="bfloat16")
    met_p = make_icl_step(model, opt, NCLS, LABELED_BS, (PATCH, PATCH), CONSIS)(
        {"image": torch.from_numpy(xt), "label": torch.from_numpy(y).long()})

    for k in METRIC_KEYS:
        assert met_p[k].dtype == torch.float32
        np.testing.assert_allclose(float(met_p[k]), float(met_j[k]), rtol=1e-4, err_msg=k)
    apart = {}
    for (name, p), buf in zip(model.named_parameters(), opt.momentum_buffers):
        assert p.dtype == buf.dtype == torch.bfloat16, name
        got, want = p.detach().float(), new[name].float()
        scale = max(float(got.abs().max()), float(want.abs().max()))
        ulp = float(np.spacing(np.float32(scale))) * 2 ** 16  # bf16's ulp at the tensor's scale
        apart[name] = float((got - want).abs().max()) / ulp
    assert max(apart.values()) <= 2, {k: v for k, v in apart.items() if v > 2}
    assert any(apart.values())  # the dithers are the two packages' own
    heads = {n: c for n, c in sizes.items() if ".attn_convs" in n}
    assert_running_stats(model, {n: c for n, c in sizes.items() if n not in heads}, old, new)
    assert len(heads) == 12  # 2 per attention conv, 3 in each of the two heads


def _supervised_cfg(tmp_path, state_dtype, tries):
    return ExperimentConfig(root_path="in-memory", exp="bf16", model="unet", num_classes=4,
                            max_iterations=12, batch_size=4, patch_size=(16, 16), labeled_num=7,
                            state_dtype=state_dtype, num_tries=tries, val_interval=0,
                            experiments_dir=str(tmp_path))


def test_supervised_unet_bf16_state_trains_checkpoints_and_refuses_f32(tmp_path):
    rng = np.random.default_rng(3)
    batch = {"image": rng.normal(size=(4, 1, 16, 16)).astype(np.float32),
             "label": rng.integers(0, 4, (4, 16, 16))}
    torch.manual_seed(0)
    trainer = Trainer(_supervised_cfg(tmp_path, "bfloat16", "a"), device="cpu")
    result = trainer.fit([batch] * 12)
    losses = [r["loss"] for r in result["log"]]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.bfloat16 for p in trainer.model.parameters())
    assert all(b.dtype == torch.bfloat16 for b in trainer.optimizer.momentum_buffers)
    buffers = dict(trainer.model.named_buffers())
    assert all(v.dtype in (torch.float32, torch.int64) for v in buffers.values())

    restored = Trainer(_supervised_cfg(tmp_path, "bfloat16", "a"), device="cpu")
    restored.restore_state()
    want, got = trainer.train_state(), restored.train_state()
    for k, v in want["model"].items():
        assert torch.equal(v, got["model"][k]), k
    for i, s in want["optimizer"]["state"].items():
        assert torch.equal(s["momentum_buffer"], got["optimizer"]["state"][i]["momentum_buffer"])
    assert (got["count"], got["iteration"], got["state_dtype"]) == (12, 12, "bfloat16")

    f32 = Trainer(_supervised_cfg(tmp_path, "float32", "b"), device="cpu")
    f32_result = f32.fit([batch] * 12)
    ratio = result["saves"][-1]["bytes"] / f32_result["saves"][-1]["bytes"]
    assert 0.45 < ratio < 0.56, ratio
    with pytest.raises(ValueError, match="state_dtype"):
        restored.load_train_state(f32.train_state())
    with pytest.raises(ValueError, match="state_dtype"):
        f32.load_train_state(trainer.train_state())


def test_fast_configuration_resume_2_plus_2_is_4_bit_for_bit(tmp_path):
    """U-Net-ICL at 32^2 with the fast configuration's options (bf16 state,
    the fused pair, the device bank with its draws, groups of 2, 2 in
    flight): 2 steps, a save, a fresh trainer's restore and 2 more against
    4 uninterrupted, every parameter, buffer and momentum bit for bit."""
    from icl_tpu_torch.data.device_bank import bank_batches, build_acdc_bank, two_stream_index_batches
    from icl_tpu_torch.data.synth import synthetic_acdc
    from icl_tpu_torch.utils.checkpoint import host_copy

    slices, _ = synthetic_acdc(10, 0, 40, 1, 4, seed=1)
    image_bank, label_bank = build_acdc_bank(slices, 32, "cpu")
    stream = bank_batches(image_bank, label_bank, two_stream_index_batches(4, 10, 4, 2, seed=1),
                          seed=1)
    batches = [next(stream) for _ in range(4)]

    def cfg(tries, **kw):
        return ExperimentConfig(root_path="in-memory", exp="fast", model="icl_unet", num_classes=4,
                                max_iterations=4, batch_size=4, labeled_bs=2, patch_size=(32, 32),
                                labeled_num=7, num_tries=tries, val_interval=0, fuse_icl_pair=True,
                                state_dtype="bfloat16", device_augment=True, scan_steps=2,
                                dispatch_depth=2, experiments_dir=str(tmp_path), **kw)

    def run(tries, part, restore=None, **kw):
        torch.manual_seed(0)
        trainer = Trainer(cfg(tries, **kw), device="cpu")
        if restore:
            trainer.restore_state("step_00000002")
        trainer.fit(part)
        return trainer, host_copy(trainer.train_state())

    _, whole = run("whole", batches)
    run("first", batches[:2], checkpoint_interval=2)
    resumed, state = run("first", batches[2:], restore=True, checkpoint_interval=2)
    assert state["iteration"] == state["count"] == 4
    for k, v in whole["model"].items():
        assert torch.equal(v, state["model"][k]), k
    for i, s in whole["optimizer"]["state"].items():
        assert torch.equal(s["momentum_buffer"], state["optimizer"]["state"][i]["momentum_buffer"])
    assert torch.equal(whole["rng"]["cpu"], state["rng"]["cpu"])
