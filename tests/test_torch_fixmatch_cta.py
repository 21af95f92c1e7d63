"""icl_tpu_torch's FixMatch-CTA path against the JAX package's:
`CTATransform` and `WeakStrongAugment`; `cta_batches` (policies, probes
and arrays); `CTATrainer.fit` for 3 steps in each `rate_lag` (the learned
rates), and its fused probe against a separate probe forward; the
Swin-UNet's step against the JAX step (embed 12, 64^2, window 4, f32;
metrics 1e-4 relative, gradients and updates within 1e-3 of their largest
magnitude plus 1e-6); the models it refuses (every one but the U-Net and
the Swin-UNet, among them those whose forward returns a tuple, on which
the JAX step fails); a resume beside the JAX one
(its step count and its save names); and the CLI on the CPU, its final
save, its resume, and its need of a card otherwise. The step itself is
held against the JAX step in `test_torch_fixmatch_cta_step.py`.

Small sizes: the default U-Net features, 4 classes, batch 4 with 2
labeled, 16^2, f32, JAX weights drawn with numpy, dropout off on both
sides. Both packages zoom through scipy, the reference's code, and the
transforms and `cta_batches` again each through its own C++ helper. Where
both packages draw a
`cutout`, the JAX op's unseeded generator is replaced by one seeded as the
port's (`seed + 3`). Tolerances: arrays, policies and probes equal; rates
after `fit` 1e-5; the fused and the separate proximity 1e-5.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.config import ExperimentConfig as JaxConfig
from icl_tpu.data import ctaugment as jax_cta
from icl_tpu.data import transforms as jax_transforms
from icl_tpu.data.pipeline import cta_batches as jax_cta_batches
from icl_tpu.data.synth import make_synthetic_acdc
from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.train.cta import CTATrainer as JaxCTATrainer
from icl_tpu.train.optim import make_sgd
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_fixmatch_cta_step as jax_make_fixmatch_cta_step
from icl_tpu.utils import checkpoint as jax_ckpt

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data import ctaugment as cta
from icl_tpu_torch.data.pipeline import cta_batches
from icl_tpu_torch.data.synth import synthetic_acdc
from icl_tpu_torch.data.transforms import CTATransform, WeakStrongAugment
from icl_tpu_torch.models.layers import Dropout
from icl_tpu_torch.scripts import train_fixmatch_cta_2D as cli
from icl_tpu_torch.train.cta import CTATrainer
from icl_tpu_torch.train.steps import FIXMATCH_METRIC_KEYS
from icl_tpu_torch.utils.convert import unet2d_state_dict_from_jax
from _torch_native import native_on_both, scipy_on_both  # noqa: F401  (fixtures)
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_icl import draw_tree, no_drop_path  # noqa: F401  (a fixture)

NCLS, BATCH, LABELED_BS, STEP_SIDE, FIT_SIDE = 4, 4, 2, 32, 16
BASE_LR, MAX_IT, SEED = 0.01, 10, 11
MAKE_RNG = np.random.default_rng


def seed_jax_cutout(monkeypatch, seed: int) -> None:
    """The JAX cutout's `np.random.default_rng()` (no seed) returns one
    generator seeded `seed`, as the port's `cta_batches` seeds its own;
    seeded calls stay numpy's."""
    shared = MAKE_RNG(seed)
    monkeypatch.setattr(jax_cta.np.random, "default_rng",
                        lambda *a: MAKE_RNG(*a) if a else shared)


def _slices(n: int = 12, size: int = 24):
    slices, _ = synthetic_acdc(n, 0, size, 1, NCLS, seed=3)
    return slices


def _no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


# ---- data ------------------------------------------------------------------
def test_transforms_match_jax(scipy_on_both, monkeypatch):
    _assert_transforms_match(monkeypatch)


def test_transforms_match_jax_on_the_native_path(native_on_both, monkeypatch):
    _assert_transforms_match(monkeypatch)


def _assert_transforms_match(monkeypatch):
    item = _slices()[5]
    learner = cta.CTAugment(seed=1)
    port, ref = CTATransform((20, 28), learner), jax_transforms.CTATransform((20, 28), None)
    policies = [(learner.policy(False, True), learner.policy(False, False)) for _ in range(8)]
    policies.append(([("cutout", [0.7]), ("rotate", [0.2])], learner.policy(False, False)))
    for i, (weak, strong) in enumerate(policies):
        seed_jax_cutout(monkeypatch, i)
        got = port(item["image"], item["label"], weak, strong, MAKE_RNG(i))
        want = ref(item["image"], item["label"], weak, strong)
        for k in ("image_weak", "image_strong"):
            assert got[k].shape == (1, 20, 28) and got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k][0], want[k][..., 0], err_msg=f"{k} {weak} {strong}")
        assert got["label_aug"].dtype == want["label_aug"].dtype == np.int32
        np.testing.assert_array_equal(got["label_aug"], want["label_aug"])
    # square: a rot90 of a non-square patch changes its shape, in both packages
    got = WeakStrongAugment((20, 20))(item["image"], item["label"], MAKE_RNG(2))
    want = jax_transforms.WeakStrongAugment((20, 20))(item["image"], item["label"], MAKE_RNG(2))
    for k in ("image", "image_weak", "image_strong"):
        assert got[k].shape == (1, 20, 20) and got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k][0], want[k][..., 0], err_msg=k)
    assert got["label_aug"].dtype == np.uint8
    np.testing.assert_array_equal(got["label_aug"], want["label_aug"])


def _recording(learner):
    """`learner.policy` recording each policy it draws, in order."""
    drawn, policy = [], learner.policy

    def record(probe, weak):
        drawn.append(policy(probe, weak))
        return drawn[-1]

    learner.policy = record
    return drawn


@pytest.mark.parametrize("jax_cutout", ["unseeded", "seeded_as_the_port"])
def test_cta_batches_match_jax(scipy_on_both, monkeypatch, jax_cutout):
    """4 batches from learners updated alike after each: the same policies
    and probes, and the same arrays for every batch whose weak policy drew
    no cutout (with the JAX cutout seeded as the port's: for every batch)."""
    _assert_cta_batches_match(monkeypatch, jax_cutout)


def test_cta_batches_match_jax_on_the_native_path(native_on_both, monkeypatch):
    _assert_cta_batches_match(monkeypatch, "seeded_as_the_port")


def _assert_cta_batches_match(monkeypatch, jax_cutout):
    if jax_cutout == "seeded_as_the_port":
        seed_jax_cutout(monkeypatch, SEED + 3)
    slices = _slices()
    port_cta, jax_cta_learner = cta.CTAugment(seed=SEED), jax_cta.CTAugment(seed=SEED)
    drawn = _recording(port_cta)
    args = (6, BATCH, LABELED_BS, (FIT_SIDE, FIT_SIDE))
    got_it = cta_batches(slices, *args, port_cta, seed=SEED)
    want_it = jax_cta_batches(slices, *args, jax_cta_learner, seed=SEED)
    compared = 0
    for b in range(4):
        got, want = next(got_it), next(want_it)
        assert got["probe_policy"] == want["probe_policy"] == drawn[3 * b + 2]
        assert got["probe_image"].shape == (1, 1, FIT_SIDE, FIT_SIDE)
        np.testing.assert_array_equal(got["probe_image"][:, 0], want["probe_image"][..., 0])
        np.testing.assert_array_equal(got["probe_label"], want["probe_label"])
        assert got["probe_label"].dtype == np.int32
        if jax_cutout == "seeded_as_the_port" or "cutout" not in dict(drawn[3 * b]):
            compared += 1
            for k in ("image_weak", "image_strong"):
                assert got[k].shape == (BATCH, 1, FIT_SIDE, FIT_SIDE) and got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k][:, 0], want[k][..., 0], err_msg=f"{b} {k}")
            assert got["label_aug"].dtype == np.int32
            np.testing.assert_array_equal(got["label_aug"], want["label_aug"])
        for learner in (port_cta, jax_cta_learner):
            learner.update_rates(got["probe_policy"], 0.3 + 0.1 * b)
    with_cutout = sum("cutout" in dict(drawn[3 * b]) for b in range(4))
    assert compared == (4 if jax_cutout == "seeded_as_the_port" else 4 - with_cutout) >= 3


# ---- the trainer -------------------------------------------------------------
@functools.cache
def _jax_shapes(side: int, name: str = "unet"):
    model = jax_net_factory(name, 1, NCLS)
    return model, jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((BATCH, side, side, 1)), train=True))


def _cfg(tmp_path, cls=ExperimentConfig, **kw):
    base = dict(root_path="in-memory-ACDC", model="unet", num_classes=NCLS, patch_size=(FIT_SIDE,) * 2,
                batch_size=BATCH, labeled_bs=LABELED_BS, max_iterations=6, base_lr=BASE_LR,
                seed=SEED, experiments_dir=str(tmp_path), exp="cta", labeled_num=3)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def jax_trainer():
    """One JAX CTATrainer (its jitted step compiled once for the module),
    flax's Dropout the identity, and its initial state on the host (the
    JAX fit donates the state it is given: `_on_device` copies it)."""
    from flax import linen as flax_nn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        trainer = JaxCTATrainer(_cfg("unused", JaxConfig))
        _, shapes = _jax_shapes(FIT_SIDE)
        yield trainer, TrainState.create(draw_tree(shapes["params"], 30),
                                         draw_tree(shapes["batch_stats"], 31), trainer.tx)


def _on_device(state):
    return jax.tree_util.tree_map(jnp.array, state)


def _port_trainer(cfg, state) -> CTATrainer:
    trainer = CTATrainer(cfg, device="cpu")
    _no_dropout(trainer.model).load_state_dict(
        unet2d_state_dict_from_jax(state.params, state.batch_stats), strict=True)
    return trainer


def _rates(learner) -> np.ndarray:
    return np.concatenate([np.concatenate([np.asarray(r) for r in learner.rates[k]])
                           for k in sorted(learner.rates) if len(learner.rates[k])])


@pytest.mark.parametrize("rate_lag", [0, 1])
def test_fit_learns_the_jax_rates(jax_trainer, scipy_on_both, monkeypatch, tmp_path, rate_lag):
    seed_jax_cutout(monkeypatch, SEED + 3)
    trainer_j, state0 = jax_trainer
    slices = _slices()
    args = (6, BATCH, LABELED_BS, (FIT_SIDE, FIT_SIDE))
    jax_learner, port_learner = jax_cta.CTAugment(seed=SEED), cta.CTAugment(seed=SEED)
    state = trainer_j.fit(_on_device(state0), jax_cta_batches(slices, *args, jax_learner, seed=SEED),
                          jax_learner, max_steps=3, rate_lag=rate_lag)
    assert int(state.step) == 3
    trainer = _port_trainer(_cfg(tmp_path), state0)
    result = trainer.fit(cta_batches(slices, *args, port_learner, seed=SEED), port_learner,
                         max_steps=3, rate_lag=rate_lag)
    assert [r["iteration"] for r in result["log"]] == [1, 2, 3] and trainer.iteration == 3
    assert all(np.isfinite(r[k]) for r in result["log"] for k in FIXMATCH_METRIC_KEYS)
    got, want = _rates(port_learner), _rates(jax_learner)
    assert (got != 1.0).sum() >= 1 and (want != 1.0).sum() >= 1
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the separate probe forward gives the fused one's value on the same weights
    probe = next(cta_batches(slices, *args, cta.CTAugment(seed=SEED), seed=SEED))
    fused = trainer.step_fn(trainer.to_device(probe))["probe_proximity"]
    assert abs(float(fused) - trainer.probe_proximity(probe["probe_image"], probe["probe_label"])) < 1e-5


@pytest.mark.parametrize("model", ["icl_unet", "unet_cct", "unet_urpc", "unet_ds", "icl_swinunet",
                                   "unet_3D_icl"])
def test_trainer_refuses_every_model_but_the_unet(tmp_path, model):
    """Every model but the U-Net and the Swin-UNet (the two whose forward
    returns one logits tensor) is refused before anything is built, with
    the reason."""
    with pytest.raises(ValueError, match="trains \\['unet', 'swinunet'\\].*one logits tensor"):
        CTATrainer(_cfg(tmp_path, model=model), device="cpu")


def test_swin_unet_step_matches_jax(tmp_path, no_drop_path):
    """CTATrainer's FixMatch step on the Swin-UNet (embed 12, 64^2, window
    4, f32, drop path off on both sides) against the JAX step with the
    fused probe: metrics, every gradient and update, as
    `test_torch_fixmatch_cta_step.py` holds the U-Net's (the JAX CLI's
    `--model swinunet`); the window attention of the weak forward runs at
    batch 4 and that of the strong forward at batch 2."""
    from icl_tpu.models import swin2d as jax_swin2d
    from test_torch_fixmatch_cta_step import _assert_step, _jax_step, _port_batch, _step_batch
    from test_torch_icl import no_port_drop_path
    from icl_tpu_torch.models import swin2d
    from icl_tpu_torch.ops import window_attention as wa
    from icl_tpu_torch.utils import convert

    side, window, embed = 64, 4, 12
    model_j = jax_net_factory("swinunet", 1, NCLS, swin_cfg=jax_swin2d.SwinConfig(
        img_size=side, window_size=window, embed_dim=embed))
    shapes = jax.eval_shape(lambda: model_j.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((BATCH, side, side, 1)), train=True))
    params = draw_tree(shapes["params"], 50)
    arrays = _step_batch(51, side)
    conf = 0.3
    grads, new_state, met_j = _jax_step(model_j, params, {}, arrays, conf, jnp.float32)

    def sd(tree):
        return convert.swinunet2d_state_dict_from_jax(tree["swin_unet"], side, window,
                                                      torch_prefix="swin_unet.")

    cfg = _cfg(tmp_path, model="swinunet", patch_size=(side, side), model_kwargs={
        "swin_cfg": swin2d.SwinConfig(img_size=side, window_size=window, embed_dim=embed)})
    trainer = CTATrainer(cfg, conf_thresh=conf, device="cpu")
    old = sd(params)
    trainer.model.load_state_dict(old, strict=True)
    no_port_drop_path(trainer.model)
    batches = []
    real = wa.window_attention_fwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wa, "window_attention_fwd", lambda q, *a, **k: batches.append(q.shape[0]) or real(q, *a, **k))
        met_p = trainer.step_fn(_port_batch(arrays, torch.float32))
    _assert_step(trainer.model, old, sd(grads), sd(new_state.params), met_p, met_j)
    per_forward = len(batches) // 3  # the weak, the strong and the probe's forwards
    windows = (side // 4 // window) ** 2
    assert batches[:per_forward][0] == BATCH * windows
    assert batches[per_forward:2 * per_forward][0] == (BATCH - LABELED_BS) * windows
    assert batches[2 * per_forward] == windows


def test_models_with_one_logits_tensor_only():
    """The CLI refuses a model whose forward returns a tuple; the JAX step,
    here traced only, fails on such a model at its first call."""
    with pytest.raises(ValueError, match="one logits tensor"):
        cli.main(["--model", "unet_urpc", "--device", "cpu"])
    model_j, shapes = _jax_shapes(FIT_SIDE, "unet_ds")
    x = jnp.zeros((BATCH, FIT_SIDE, FIT_SIDE, 1))
    tx = make_sgd(BASE_LR, MAX_IT)
    state = jax.eval_shape(lambda v: TrainState.create(v["params"], v["batch_stats"], tx), shapes)
    batch = {"image_weak": x, "image_strong": x,
             "label_aug": jnp.zeros((BATCH, FIT_SIDE, FIT_SIDE), jnp.int32)}
    with pytest.raises(TypeError, match="tuple"):
        jax.eval_shape(jax_make_fixmatch_cta_step(model_j, tx, NCLS, LABELED_BS), state, batch,
                       jax.random.PRNGKey(0))


def test_resume_continues_from_its_step_beside_jax(jax_trainer, scipy_on_both, monkeypatch, tmp_path):
    """3 steps saved every step, then a resume to max_iterations 4. The
    port restores iteration 3, takes 1 step and saves step_00000004; the
    JAX fit counts from 0 again, takes 4 more steps (state.step 7) and
    writes its saves under step names 1-4, so step_00000004 holds step 7.
    Each port fit ends with state_last; the JAX fit saves no final state."""
    seed_jax_cutout(monkeypatch, SEED + 3)
    trainer_j, state0 = jax_trainer
    slices = _slices()
    args = (6, BATCH, LABELED_BS, (FIT_SIDE, FIT_SIDE))

    # JAX, as its CLI resumes (the JAX fit reads the interval from its config)
    monkeypatch.setattr(trainer_j, "cfg", _cfg(tmp_path / "jax", JaxConfig, max_iterations=4,
                                               checkpoint_interval=1))
    snap_j = trainer_j.cfg.snapshot_path
    learner = jax_cta.CTAugment(seed=SEED)
    trainer_j.fit(_on_device(state0), jax_cta_batches(slices, *args, learner, seed=SEED), learner,
                  max_steps=3, snapshot_path=snap_j)
    restored = _on_device(jax_ckpt.load_train_state(snap_j, state0, name="last"))
    JaxCTATrainer.restore_cta(snap_j, learner)
    state = trainer_j.fit(restored, jax_cta_batches(slices, *args, learner, seed=SEED), learner,
                          max_steps=4, snapshot_path=snap_j)
    jax_saves = {jax_ckpt._checkpoint_step_of(p): int(jax_ckpt.load_pytree(p, state0).step)
                 for p in jax_ckpt.list_step_checkpoints(snap_j)}
    assert int(state.step) == 7 and jax_saves == {2: 5, 3: 6, 4: 7}

    # the port, as its CLI resumes
    cfg = _cfg(tmp_path / "port", max_iterations=4, checkpoint_interval=1)
    learner = cta.CTAugment(seed=SEED)
    first = _port_trainer(cfg, state0).fit(cta_batches(slices, *args, learner, seed=SEED), learner,
                                           max_steps=3, snapshot_path=cfg.snapshot_path)
    assert [s["iteration"] for s in first["saves"]] == [1, 2, 3, 3]
    assert os.path.basename(first["saves"][-1]["path"]) == "state_last.pt"
    trainer = CTATrainer(cfg, device="cpu")
    assert trainer.restore_state() == 3
    learner = cta.CTAugment(seed=SEED)
    assert CTATrainer.restore_cta(cfg.snapshot_path, learner)
    result = trainer.fit(cta_batches(slices, *args, learner, seed=SEED), learner,
                         snapshot_path=cfg.snapshot_path)
    assert [r["iteration"] for r in result["log"]] == [4] and trainer.iteration == 4
    assert trainer.optimizer.count == 4
    port_saves = {int(os.path.basename(p)[11:19]): torch.load(p, weights_only=True)["iteration"]
                  for p in sorted(os.listdir(os.path.join(cfg.snapshot_path, "model")))
                  for p in [os.path.join(cfg.snapshot_path, "model", p)] if "state_step_" in p}
    assert port_saves == {2: 2, 3: 3, 4: 4}
    last = torch.load(os.path.join(cfg.snapshot_path, "model", "state_last.pt"), weights_only=True)
    assert last["iteration"] == 4


# ---- the CLI -----------------------------------------------------------------
@pytest.fixture(scope="module")
def acdc_root(tmp_path_factory):
    """72 slices: `--labeled_num 3` takes the first 68 as labeled."""
    root = tmp_path_factory.mktemp("ACDC")
    return make_synthetic_acdc(str(root), num_slices=72, num_volumes=1, slice_size=24, vol_depth=2,
                               num_classes=NCLS, seed=0)


def test_cli_trains_and_resumes_on_cpu_and_needs_a_card(acdc_root, tmp_path, monkeypatch, capsys):
    (tmp_path / "run").mkdir()
    monkeypatch.chdir(tmp_path / "run")  # the snapshots land in ../experiments
    common = ["--root_path", acdc_root, "--exp", "ACDC_t/FixMatch_CTA", "--labeled_num", "3",
              "--num_tries", "t", "--patch_size", str(FIT_SIDE), str(FIT_SIDE), "--batch_size",
              str(BATCH), "--labeled_bs", str(LABELED_BS), "--checkpoint_interval", "2",
              "--device", "cpu"]
    result = cli.main(common + ["--max_iterations", "2"])
    assert [r["iteration"] for r in result["log"]] == [1, 2]
    assert all(np.isfinite(r[k]) for r in result["log"] for k in FIXMATCH_METRIC_KEYS)
    model_dir = tmp_path / "experiments" / "ACDC_t" / "FixMatch_CTA_3_labeled" / "unet_exp_t" / "model"
    assert {"state_step_00000002.pt", "state_last.pt", "cta_state.json"} <= set(os.listdir(model_dir))
    out = capsys.readouterr().out
    assert "Learned CTA rates:" in out and "Training Finished!" in out
    result = cli.main(common + ["--max_iterations", "3", "--resume", "--cta_rate_lag", "0"])
    out = capsys.readouterr().out
    assert "Restored the train state at iteration 2" in out and "Restored persisted CTA rates" in out
    assert [r["iteration"] for r in result["log"]] == [3]
    # the run ends with its state, between the rolling saves' steps too
    assert torch.load(model_dir / "state_last.pt", weights_only=True)["iteration"] == 3
    assert cli.parse_args([]).patch_size == [256, 256] and cli.parse_args([]).batch_size == 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(common[:-2] + ["--max_iterations", "1"])
