"""icl_tpu_torch's analytic FLOP count (`utils/flops.py`, FlopCounterMode
over a call that runs) against the JAX package's jaxpr walk
(`icl_tpu/utils/flops.py`, a trace): a matmul, a batched einsum, 2D and 3D
convolutions, a recompute, and whole training steps of U-Net-ICL 2D, the
U-Net-ICL 3D and the Swin-UNet 2D at window 7 (N = 49, where the JAX
package attends with einsums and the port with the fused op); the
window-attention op's count by formula, which the CUDA wrappers add at each
launch; and `Trainer.fit`'s two log lines beside the JAX trainer's.

Agreement: the small functions exactly; the steps within 1% once the
named gap is taken off. One gap is named: the fused attention's backward
recomputes the scores q.k^T (10 B*H*N^2*D against the einsum backward's
8, as the JAX package's own fused backward does), so the port counts 2
B*H*N^2*D more per attention call of a step (the Swin-UNet's; the U-Nets
have none). Small sizes: U-Net-ICL 2D at 32^2, U-Net-ICL 3D at 16^3, batch
4 of which 2 labeled; Swin-UNet at 224^2 (window 7 needs the four stages'
56, 28, 14, 7) with embed 12, batch 2.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.config import ExperimentConfig as JaxConfig
from icl_tpu.models import swin2d as jax_swin2d
from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.models.unet2d_icl import UNetICL as JaxUNetICL
from icl_tpu.models.unet3d_icl import UNet3DICL as JaxUNet3DICL
from icl_tpu.train.optim import make_sgd
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_icl_step as jax_make_icl_step
from icl_tpu.train.steps import make_supervised_step as jax_make_supervised_step
from icl_tpu.train.trainer import Trainer as JaxTrainer
from icl_tpu.utils import flops as jax_flops

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.models import swin2d
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.ops import window_attention as wa
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import make_icl_step, make_supervised_step
from icl_tpu_torch.train.trainer import Trainer
from icl_tpu_torch.utils import flops
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

NCLS, BATCH, LABELED_BS = 4, 4, 2
REL = 0.01


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_matmul_and_batched_einsum_count_as_jax():
    a, b = _rng_arrays(0, (24, 40), (40, 16))
    want = jax_flops.count_matmul_flops(jnp.dot, jnp.asarray(a), jnp.asarray(b))
    got = flops.count_matmul_flops(torch.mm, torch.from_numpy(a), torch.from_numpy(b))
    assert got == want == 2 * 24 * 40 * 16
    q, k = _rng_arrays(1, (2, 3, 49, 8), (2, 3, 49, 8))
    spec = "bhnd,bhmd->bhnm"
    want = jax_flops.count_matmul_flops(lambda x, y: jnp.einsum(spec, x, y), jnp.asarray(q), jnp.asarray(k))
    got = flops.count_matmul_flops(lambda x, y: torch.einsum(spec, x, y), torch.from_numpy(q),
                                   torch.from_numpy(k))
    assert got == want == 2 * 2 * 3 * 49 * 49 * 8
    rows = flops.per_op_flops(torch.mm, torch.from_numpy(a), torch.from_numpy(b))
    assert rows == [{"op": "aten.mm", "sig": "(24x40,40x16)->24x16", "flops": 2 * 24 * 40 * 16,
                     "count": 1}]
    assert jax_flops.per_op_flops(jnp.dot, jnp.asarray(a), jnp.asarray(b))[0]["flops"] == rows[0]["flops"]


@pytest.mark.parametrize("dims", [2, 3])
def test_convolution_and_its_gradients_count_as_jax(dims):
    """A 3^d convolution (Cin 3, Cout 5), forward alone and with the input
    and weight gradients."""
    spatial = (10,) * dims
    x, w = _rng_arrays(2, (2, *spatial, 3), (*(3,) * dims, 3, 5))
    conv = {2: "NHWC", 3: "NDHWC"}[dims]
    kernel = {2: "HWIO", 3: "DHWIO"}[dims]

    def jax_conv(x, w):
        return jax.lax.conv_general_dilated(x, w, (1,) * dims, "SAME",
                                            dimension_numbers=(conv, kernel, conv))

    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    wt = torch.from_numpy(np.moveaxis(np.moveaxis(w, -1, 0), -1, 1).copy())
    torch_conv = {2: torch.nn.functional.conv2d, 3: torch.nn.functional.conv3d}[dims]
    want = jax_flops.count_matmul_flops(jax_conv, jnp.asarray(x), jnp.asarray(w))
    assert flops.count_matmul_flops(lambda a, b: torch_conv(a, b, padding=1), xt, wt) == want
    want_grad = jax_flops.count_matmul_flops(
        jax.grad(lambda a, b: jnp.sum(jax_conv(a, b) ** 2), argnums=(0, 1)), jnp.asarray(x), jnp.asarray(w))

    def torch_grad(a, b):
        a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
        (torch_conv(a, b, padding=1) ** 2).sum().backward()

    assert flops.count_matmul_flops(torch_grad, xt, wt) == want_grad == 3 * want


def test_recompute_counts_as_jax_remat():
    """Two matmuls under jax.checkpoint / torch's checkpoint: the gradient's
    count holds the forward, its recompute and the backward."""
    x, w1, w2 = _rng_arrays(3, (16, 32), (32, 24), (24, 8))

    def jax_f(x, w1, w2):
        return jnp.sum(jnp.tanh(x @ w1) @ w2)

    want = jax_flops.count_matmul_flops(jax.grad(jax.checkpoint(jax_f), argnums=(1, 2)),
                                        *map(jnp.asarray, (x, w1, w2)))

    def torch_grad(x, w1, w2):
        w1, w2 = w1.clone().requires_grad_(), w2.clone().requires_grad_()
        out = torch.utils.checkpoint.checkpoint(lambda a, b, c: (torch.tanh(a @ b) @ c).sum(),
                                                x, w1, w2, use_reentrant=False)
        out.backward()

    got = flops.count_matmul_flops(torch_grad, *map(torch.from_numpy, (x, w1, w2)))
    forward = 2 * (16 * 32 * 24 + 16 * 24 * 8)
    backward = 2 * (16 * 32 * 24 + 2 * 16 * 24 * 8)  # dW1; dH and dW2
    assert got == want == forward + backward + 2 * 16 * 32 * 24  # x @ w1 recomputed


def test_window_attention_counts_its_formulas():
    """The op's forward and backward at a 2D Swin stage shape: the plain
    versions' matmuls on the CPU give the formulas that the CUDA wrappers
    add at each launch (forward 4*B*H*N^2*D, backward 10*B*H*N^2*D)."""
    B, H, N, D = 8, 3, 49, 32
    q, k, v = (torch.randn(B, H, N, D, requires_grad=True) for _ in range(3))
    bias = torch.randn(H, N, N, requires_grad=True)
    mask = torch.zeros(4, N, N)
    fwd = flops.count_matmul_flops(lambda: wa.window_attention(q, k, v, bias, mask=mask, scale=0.2))
    assert fwd == 4 * B * H * N * N * D
    out = wa.window_attention(q, k, v, bias, mask=mask, scale=0.2)
    bwd = flops.count_matmul_flops(lambda: out.sum().backward())
    assert bwd == 10 * B * H * N * N * D
    with flops.counting() as c:  # what a CUDA wrapper adds
        flops.add_kernel_flops(7.0)
        with flops.counting() as inner:
            flops.add_kernel_flops(5.0)
    assert (c.total, inner.total) == (12.0, 5.0)
    flops.add_kernel_flops(1.0)  # no count open: nothing to add to


def _jax_step_flops(make_step, model, x_shapes, y_shape, init_args):
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, *init_args, train=True))
    tx = make_sgd(0.01, 10)
    state = jax.eval_shape(lambda: TrainState.create(shapes["params"], shapes.get("batch_stats", {}), tx))
    batch = {"image": jax.ShapeDtypeStruct(x_shapes, jnp.float32),
             "label": jax.ShapeDtypeStruct(y_shape, jnp.int32)}
    return jax_flops.analytic_step_flops(make_step(model, tx), state, batch, jax.random.PRNGKey(0))


def _port_step_flops(make_step, model, x_shape, y_shape, ncls):
    opt = PolySGD(model.parameters(), 0.01, 10)
    step = make_step(model, opt)
    batch = {"image": torch.randn(x_shape), "label": torch.randint(0, ncls, y_shape)}
    with flops.counting() as c:
        step(batch)
    return c.total, c


def _assert_close(got, want, gap=0.0):
    """got - gap within REL of want."""
    assert abs(got - gap - want) <= REL * want, (got, gap, want, (got - gap) / want - 1)


def test_icl_unet_2d_step_counts_as_jax():
    side = 32
    model = JaxUNetICL(1, NCLS, patch_size=side)
    xl = jnp.zeros((LABELED_BS, side, side, 1))
    want = _jax_step_flops(
        lambda m, tx: jax_make_icl_step(m, tx, NCLS, LABELED_BS, (side, side), 50.0), model,
        (BATCH, side, side, 1), (BATCH, side, side), (xl, xl))
    port = net_factory("icl_unet", 1, NCLS, device="cpu", patch_size=side)
    got, count = _port_step_flops(
        lambda m, opt: make_icl_step(m, opt, NCLS, LABELED_BS, (side, side), 50.0), port,
        (BATCH, 1, side, side), (BATCH, side, side), NCLS)
    assert count.kernel_flops == 0
    _assert_close(got, want)


def test_icl_unet_3d_step_counts_as_jax():
    side = 16
    model = JaxUNet3DICL(1, 2, patch_size=side)
    xl = jnp.zeros((LABELED_BS, side, side, side, 1))
    want = _jax_step_flops(
        lambda m, tx: jax_make_icl_step(m, tx, 2, LABELED_BS, (side,) * 3, 10.0), model,
        (BATCH, side, side, side, 1), (BATCH, side, side, side), (xl, xl))
    port = net_factory("unet_3D_icl", 1, 2, device="cpu", patch_size=side)
    got, _ = _port_step_flops(
        lambda m, opt: make_icl_step(m, opt, 2, LABELED_BS, (side,) * 3, 10.0), port,
        (BATCH, 1, side, side, side), (BATCH, side, side, side), 2)
    _assert_close(got, want)


def test_swin_unet_2d_step_counts_as_jax_but_the_scores_recompute():
    side, batch, embed = 224, 2, 12
    jax_cfg = jax_swin2d.SwinConfig(img_size=side, window_size=7, embed_dim=embed)
    model = jax_net_factory("swinunet", 1, NCLS, swin_cfg=jax_cfg)
    want = _jax_step_flops(lambda m, tx: jax_make_supervised_step(m, tx, NCLS), model,
                           (batch, side, side, 1), (batch, side, side),
                           (jnp.zeros((batch, side, side, 1)),))
    port = net_factory("swinunet", 1, NCLS, device="cpu",
                       swin_cfg=swin2d.SwinConfig(img_size=side, window_size=7, embed_dim=embed))
    calls = []
    real = wa.window_attention_plain_bwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wa, "window_attention_plain_bwd",
                   lambda q, *a, **k: calls.append(q.shape) or real(q, *a, **k))
        got, _ = _port_step_flops(lambda m, opt: make_supervised_step(m, opt, NCLS), port,
                                  (batch, 1, side, side), (batch, side, side), NCLS)
    # the named gap: the scores q.k^T recomputed in each fused backward
    recompute = sum(2.0 * B * H * N * N * D for B, H, N, D in calls)
    depths = swin2d.SwinConfig().depths
    assert len(calls) == sum(depths) + sum(depths[:3])  # the encoder's blocks and the decoder's
    assert recompute > REL * want  # larger than the tolerance: it has to be named
    _assert_close(got, want, gap=recompute)


def _log_lines(path: str) -> list:
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if "analytic step cost" in ln or "end-to-end analytic" in ln]


def test_fit_logs_the_jax_trainers_two_flop_lines(tmp_path):
    """U-Net at 16^2, 2 steps: the port's `fit` and the JAX trainer's log
    the step's analytic GFLOP and the end-to-end TFLOP/s in the same words,
    the port's count within 1% of JAX's; log_flops off logs neither."""
    common = dict(model="unet", num_classes=NCLS, batch_size=BATCH, labeled_bs=LABELED_BS,
                  patch_size=(16, 16), max_iterations=2, val_interval=0)
    rng = np.random.default_rng(5)
    arrays = [(rng.standard_normal((BATCH, 16, 16, 1)).astype(np.float32),
               rng.integers(0, NCLS, (BATCH, 16, 16)).astype(np.int32)) for _ in range(2)]
    jcfg = JaxConfig(**common, compile_cache_dir="", experiments_dir=str(tmp_path / "jax"))
    jt = JaxTrainer(jcfg)
    jt.fit(jt.init_state(jax.random.PRNGKey(0)), iter([{"image": x, "label": y} for x, y in arrays]))
    jax_lines = _log_lines(f"{jcfg.snapshot_path}/log.txt")

    cfg = ExperimentConfig(**common, experiments_dir=str(tmp_path / "port"))
    trainer = Trainer(cfg, device="cpu")
    batches = [{"image": torch.from_numpy(np.moveaxis(x, -1, 1).copy()), "label": torch.from_numpy(y)}
               for x, y in arrays]
    result = trainer.fit(iter(batches))
    port_lines = _log_lines(f"{cfg.snapshot_path}/log.txt")
    pattern = [r"analytic step cost: ([\d.]+) GFLOP \(", r"Training finished: 2 iters in [\d.]+s "
               r"\([\d.]+ it/s, end-to-end analytic [\d.]+ TFLOP/s at ([\d.]+) GFLOP/step\)"]
    values = {}
    for who, lines in (("jax", jax_lines), ("port", port_lines)):
        assert len(lines) == 2, (who, lines)
        values[who] = [float(re.search(p, ln).group(1)) for p, ln in zip(pattern, lines)]
    assert result["step_flops"] == trainer.step_flops > 0
    want = _jax_step_flops(lambda m, tx: jax_make_supervised_step(m, tx, NCLS),
                           jax_net_factory("unet", 1, NCLS), (BATCH, 16, 16, 1), (BATCH, 16, 16),
                           (jnp.zeros((BATCH, 16, 16, 1)),))
    _assert_close(result["step_flops"], want)
    assert values["jax"][0] == values["jax"][1] == round(want / 1e9, 1)
    assert values["port"][0] == values["port"][1] == round(trainer.step_flops / 1e9, 1)

    quiet = Trainer(ExperimentConfig(**common, log_flops=False, num_tries="q",
                                     experiments_dir=str(tmp_path / "port")), device="cpu")
    assert quiet.fit(iter(batches))["step_flops"] is None
    assert _log_lines(f"{quiet.cfg.snapshot_path}/log.txt") == []
