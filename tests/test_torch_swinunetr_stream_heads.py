"""SwinUNETR-ICL at head dims the streamed kernels take, against the JAX
package's: the train-mode forward (its 5-tuple, f32) and one ICL train
step (metrics, gradients, parameter updates, f64), weights carried by
`utils/convert.py`.

feature_size 36 with heads (1, 1, 1, 1) gives the four stages head dims
36, 72, 144 and 288: the tile of 64, two 64-column chunks of it (the
chunked kernels), and three and five chunks (fs432's head dim, and twice
it), which the chunked kernels do not fit in f32 and the streamed kernels
take, in one model. On the CPU the port's attention is the plain version
(the kernels are held against it on the card), so these tests show that
the model passes such head dims through as the JAX model does. Size and
tolerances as `test_torch_swinunetr_wide_heads.py`: patch 32^3, batch 4
with 2 labeled, drop path off on both sides, JAX on its einsum attention
path with f32 matmuls at "highest"; logits and maps 1e-4 absolute and
relative, metrics 1e-4 relative, each gradient and update within 1e-3 of
its largest magnitude plus 1e-6.
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from icl_tpu.models.swinunetr_icl import SwinUNETRICL as JaxSwinUNETRICL

from icl_tpu_torch.models.layers import build_model
from icl_tpu_torch.models.swinunetr import WindowAttention3D
from icl_tpu_torch.models.swinunetr_icl import SwinUNETRICL
from icl_tpu_torch.ops import window_attention as wa
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import METRIC_KEYS, make_icl_step
from icl_tpu_torch.utils.convert import swinunetr_icl_state_dict_from_jax
from test_torch_icl import (  # noqa: F401  (no_drop_path is a fixture)
    ATOL, LABELED_BS, NCLS, PATCH, RTOL, batch, cl2cf, draw_tree, no_drop_path, no_port_drop_path)
from test_torch_tensor_parallel_steps import _f64, jax_icl_step_f64
from test_torch_train import BASE_LR, CONSIS, MAX_IT, _assert_close_to_scale
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

FS = 36
HEADS = (1, 1, 1, 1)
HEAD_DIMS = tuple(FS * 2**i // h for i, h in enumerate(HEADS))


@functools.cache
def _jax_model_and_shapes():
    model = JaxSwinUNETRICL(in_chns=1, class_num=NCLS, img_size=PATCH, feature_size=FS, num_heads=HEADS)
    x = jnp.zeros((LABELED_BS, PATCH, PATCH, PATCH, 1))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, x, train=True))
    return model, shapes


def _variables(seed: int):
    """(JAX module, params, batch_stats) drawn with numpy, and the port's
    model carrying them."""
    model, shapes = _jax_model_and_shapes()
    params, bs = draw_tree(shapes["params"], seed), draw_tree(shapes["batch_stats"], seed + 1)
    port = build_model(SwinUNETRICL, 1, NCLS, img_size=PATCH, feature_size=FS, num_heads=HEADS,
                       device="cpu", generator=torch.Generator().manual_seed(0))
    port.load_state_dict(swinunetr_icl_state_dict_from_jax(params, bs), strict=True)
    return model, params, bs, no_port_drop_path(port)


def test_train_forward_at_head_dim_144_matches_jax(no_drop_path):
    """Also: the window attention is called at head dims 36, 72, 144 and
    288, which the wrapper's rule sends in f32 to the tile-64, chunked,
    streamed and streamed kernels."""
    jax_model, params, bs, model = _variables(21)
    seen = set()
    for m in model.modules():
        if isinstance(m, WindowAttention3D):
            def attention(q, *args, _inner=m.attention, **kw):
                seen.add((q.shape[-1], wa._route(q.shape[2], q.shape[3])))
                return _inner(q, *args, **kw)
            m.attention = attention
    x, xt, _ = batch(22)
    outs_j, _ = jax.jit(lambda p, b, xl, xu: jax_model.apply(
        {"params": p, "batch_stats": b}, xl, xu, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(params, bs, jnp.asarray(x[:LABELED_BS]),
                                                   jnp.asarray(x[LABELED_BS:]))
    outs_p = model.train()(torch.from_numpy(xt[:LABELED_BS]), torch.from_numpy(xt[LABELED_BS:]))
    for got, want in zip(outs_p[:2], outs_j[:2]):
        assert got.shape == (LABELED_BS, NCLS, PATCH, PATCH, PATCH)
        np.testing.assert_allclose(got.detach().numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)
    for maps_p, maps_j in zip(outs_p[2:], outs_j[2:]):
        for got, want in zip(maps_p, maps_j):
            np.testing.assert_allclose(got.detach().numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)
    assert HEAD_DIMS == (36, 72, 144, 288)
    assert seen == {(36, "tile"), (72, "wide"), (144, "stream"), (288, "stream")}


def test_icl_step_at_head_dim_144_matches_jax_in_f64(no_drop_path):
    """In f64 on both sides (`jax_icl_step_f64`), as the fs12 test."""
    jax_model, params, bs, model = _variables(23)
    x, xt, y = batch(24)
    case = dict(kind="swinunetr_icl", classes=NCLS, patch=PATCH, dims=3, labeled_bs=LABELED_BS,
                consis=CONSIS)
    new_state, met_j = jax_icl_step_f64(jax_model, case, params, bs, x, y)
    model = model.double().train()
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    met_p = make_icl_step(model, opt, NCLS, LABELED_BS, (PATCH,) * 3, CONSIS)(
        {"image": torch.from_numpy(xt).double(), "label": torch.from_numpy(y).long()})
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(met_p[k]), float(met_j[k]), rtol=1e-4, err_msg=k)
    grads = swinunetr_icl_state_dict_from_jax(new_state.opt_state[0], new_state.batch_stats)
    new = swinunetr_icl_state_dict_from_jax(new_state.params, new_state.batch_stats)
    old = swinunetr_icl_state_dict_from_jax(_f64(params), _f64(bs))
    for name, p in model.named_parameters():
        _assert_close_to_scale(p.grad, grads[name], f"grad {name}")
        _assert_close_to_scale(p.detach() - old[name], new[name] - old[name], f"update {name}")
