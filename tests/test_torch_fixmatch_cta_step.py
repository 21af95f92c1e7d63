"""icl_tpu_torch's FixMatch-CTA step (`make_fixmatch_cta_step` with its
fused probe) against the JAX package's: loss terms, mask ratio, probe
proximity, every gradient and updated parameter, and the BatchNorm running
stats, for the plain U-Net, the model the port's path trains; and the
step on labels outside the classes, where the JAX CE turns NaN.
`test_torch_fixmatch_cta.py` holds the rest of the path.

The U-Net at 32^2, batch 4 with 2 labeled, in f64 on both sides (the JAX
align-corners weights and one-hot kept in f64, as
`test_torch_train_unet2d.py` says why), dropout off on both sides. The
threshold keeps some unlabeled
pixels and drop others (asserted). The probe's label holds classes outside
[0, 4), whose one-hot rows are zero in both packages. Tolerances: metrics
1e-4 relative; each gradient and update within 1e-3 of its largest
magnitude plus 1e-6; running means and variances 1e-5 absolute, torch's
variance from the unbiased batch variance of each of its two train-mode
passes (of 4 and of 2 samples), flax's from the biased one.
"""
import copy
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu import losses as jax_losses
from icl_tpu.models import layers as jax_layers
from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.train.optim import make_sgd
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_fixmatch_cta_step as jax_make_fixmatch_cta_step

from icl_tpu_torch.models.layers import Dropout
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import FIXMATCH_METRIC_KEYS, make_fixmatch_cta_step
from icl_tpu_torch.utils.convert import unet2d_state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_icl import draw_tree
from test_torch_train import _assert_close_to_scale, _capture_grads
from test_torch_train_unet2d import _exact_align_corners_matrix
from test_torch_train_unet3d import _f64
from test_torch_unet3d import no_stochastic_jax  # noqa: F401  (a fixture)

NCLS, BATCH, LABELED_BS, STEP_SIDE = 4, 4, 2, 32
BASE_LR, MAX_IT = 0.01, 10
MAKE_RNG = np.random.default_rng


@functools.cache
def _jax_shapes(name: str = "unet", side: int = STEP_SIDE, **kw):
    model = jax_net_factory(name, 1, NCLS, **kw)
    return model, jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((BATCH, side, side, 1)), train=True))


def _step_batch(seed: int, side: int = STEP_SIDE):
    """(weak, strong [B, H, W], labels [B, H, W], probe image [1, H, W],
    probe label [1, H, W] with classes outside [0, 4) among them, as the
    probe policy's intensity ops can give)."""
    rng = MAKE_RNG(seed)
    shape = (BATCH, side, side)
    weak = rng.standard_normal(shape).astype(np.float32)
    strong = (weak + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    y = rng.integers(0, NCLS, shape).astype(np.int32)
    p_img = rng.standard_normal((1, side, side)).astype(np.float32)
    p_lab = rng.integers(0, NCLS + 2, (1, side, side)).astype(np.int32)
    return weak, strong, y, p_img, p_lab


def _jax_batch(arrays, dtype):
    weak, strong, y, p_img, p_lab = arrays
    return {"image_weak": jnp.asarray(weak[..., None], dtype),
            "image_strong": jnp.asarray(strong[..., None], dtype), "label_aug": jnp.asarray(y),
            "probe_image": jnp.asarray(p_img[..., None], dtype), "probe_label": jnp.asarray(p_lab)}


def _port_batch(arrays, dtype):
    weak, strong, y, p_img, p_lab = arrays
    return {"image_weak": torch.from_numpy(weak[:, None]).to(dtype),
            "image_strong": torch.from_numpy(strong[:, None]).to(dtype),
            "label_aug": torch.from_numpy(y).long(),
            "probe_image": torch.from_numpy(p_img[:, None]).to(dtype),
            "probe_label": torch.from_numpy(p_lab).long()}


def _jax_step(model, params, bs, arrays, conf, dtype):
    """One jitted JAX FixMatch step with the fused probe: (grads, new state,
    metrics) on the host."""
    tx = optax.chain(_capture_grads(), make_sgd(BASE_LR, MAX_IT))
    step = jax_make_fixmatch_cta_step(model, tx, NCLS, LABELED_BS, conf, 1.0, fused_probe=True)
    new_state, metrics = jax.device_get(jax.jit(step)(
        TrainState.create(params, bs, tx), _jax_batch(arrays, dtype), jax.random.PRNGKey(0)))
    return new_state.opt_state[0], new_state, {k: float(v) for k, v in metrics.items()}


def _assert_step(model, old, grads, new, met_p, met_j):
    assert model.training
    assert set(met_p) == set(met_j) == set(FIXMATCH_METRIC_KEYS)
    assert 0.0 < met_j["mask_ratio"] < 1.0, met_j
    for k in FIXMATCH_METRIC_KEYS:
        np.testing.assert_allclose(float(met_p[k]), met_j[k], rtol=1e-4, err_msg=k)
    for name, p in model.named_parameters():
        _assert_close_to_scale(p.grad, grads[name], f"grad {name}")
        _assert_close_to_scale(p.detach() - old[name], new[name] - old[name], f"update {name}")


def _bn_batch_variances(model):
    """{BatchNorm name: [(biased batch variance, values per channel) of each
    train-mode pass]}, filled by the model's next forwards."""
    seen = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            seen[name] = []

            def hook(mod, inp, lst=seen[name]):
                if mod.training:
                    x = inp[0].detach()
                    lst.append((x.var(dim=(0, 2, 3), unbiased=False), x.numel() // x.shape[1]))

            m.register_forward_pre_hook(hook)
    return seen


def test_fixmatch_step_matches_jax(no_stochastic_jax):
    """In f64 on both sides, the fused probe on; a threshold at which some
    unlabeled pixels are kept and some are not; the probe's label holds
    classes outside [0, 4), whose one-hot rows are zero in both."""
    model_j, shapes = _jax_shapes()
    params, bs = draw_tree(shapes["params"], 20), draw_tree(shapes["batch_stats"], 21)
    arrays = _step_batch(22)
    conf = 0.6
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "_align_corners_matrix", _exact_align_corners_matrix)
        mp.setattr(jax_losses, "one_hot", lambda labels, n: jax.nn.one_hot(labels, n, dtype=jnp.float64))
        grads, new_state, met_j = _jax_step(model_j, _f64(params), _f64(bs), arrays, conf,
                                            jnp.float64)
    old = unet2d_state_dict_from_jax(_f64(params), _f64(bs))
    model = net_factory("unet", 1, NCLS, device="cpu")
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model.load_state_dict(old, strict=True)
    model = model.double().train()
    seen = _bn_batch_variances(model)
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    met_p = make_fixmatch_cta_step(model, opt, NCLS, LABELED_BS, conf, 1.0)(
        _port_batch(arrays, torch.float64))
    assert all(v.dtype == torch.float64 and v.ndim == 0 for v in met_p.values())
    new = unet2d_state_dict_from_jax(new_state.params, new_state.batch_stats)
    _assert_step(model, old, unet2d_state_dict_from_jax(grads, new_state.batch_stats), new, met_p,
                 met_j)
    sd = model.state_dict()
    for name, passes in seen.items():
        (v1, n1), (v2, n2) = passes  # the weak pass of 4 samples, the strong one of 2
        assert n1 * (BATCH - LABELED_BS) == n2 * BATCH, name
        var0 = old[f"{name}.running_var"]
        np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(),
                                   new[f"{name}.running_mean"].numpy(), atol=1e-5, err_msg=name)
        flax_var = 0.81 * var0 + 0.09 * v1 + 0.1 * v2
        np.testing.assert_allclose(flax_var.numpy(), new[f"{name}.running_var"].numpy(), atol=1e-5,
                                   err_msg=name)
        torch_var = 0.81 * var0 + 0.09 * v1 * n1 / (n1 - 1) + 0.1 * v2 * n2 / (n2 - 1)
        np.testing.assert_allclose(sd[f"{name}.running_var"].numpy(), torch_var.numpy(), atol=1e-5,
                                   err_msg=name)
        assert int(sd[f"{name}.num_batches_tracked"]) == 2, name


def test_labels_outside_the_classes():
    """A LANCZOS rescale of a label map can overshoot past the last class
    (in `cta_batches` at the CLI's defaults, batches 5 and 6 of the stream
    hold label 4 in labeled rows). The JAX CE turns NaN there (its gather
    fills NaN out of range); the port leaves those pixels out of the CE,
    and both give them no class in the Dice target and the probe."""
    torch.manual_seed(0)
    model = net_factory("unet", 1, NCLS, device="cpu", generator=torch.Generator().manual_seed(1))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model.train()
    weak, strong, y, p_img, p_lab = _step_batch(50, 16)
    y[0, :3, :5], y[1, 7, 2] = NCLS, NCLS + 1
    batch = _port_batch((weak, strong, y, p_img, p_lab), torch.float32)
    with torch.no_grad():
        logits = copy.deepcopy(model)(batch["image_weak"])  # the step's weak pass: train mode
    lab = torch.from_numpy(y[:LABELED_BS]).long()
    valid = lab < NCLS
    logp = torch.log_softmax(logits[:LABELED_BS], 1)
    want_ce = -logp.gather(1, lab.clamp(max=NCLS - 1)[:, None])[:, 0][valid].mean()
    logits_j = jnp.asarray(np.moveaxis(logits[:LABELED_BS].numpy(), 1, -1))
    assert np.isnan(float(jax_losses.cross_entropy_loss(logits_j, jnp.asarray(y[:LABELED_BS]))))
    want_dice = float(jax_losses.multiclass_dice_loss(logits_j, jnp.asarray(y[:LABELED_BS]), NCLS,
                                                      softmax=True))
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    met = make_fixmatch_cta_step(model, opt, NCLS, LABELED_BS, 0.5, 1.0)(batch)
    np.testing.assert_allclose(float(met["loss_ce"]), float(want_ce), rtol=1e-5)
    np.testing.assert_allclose(float(met["loss_dice"]), want_dice, rtol=1e-5)
    assert all(torch.isfinite(v) for v in met.values())
    assert all(torch.isfinite(p).all() for p in model.parameters())
