"""The bf16 stochastic-rounding SGD kernel against its plain PyTorch
version, and a CUDA-graph-replayed training step against the eager one, on
the card only; every test here skips without one.

This file imports only torch, pytest and icl_tpu_torch, so it runs on a
machine without JAX, with tests/conftest.py (which imports JAX) left out:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sgd_bf16_card.py

Covered: the kernel at ragged lengths, at addresses that are not 16-byte
aligned (its scalar path) and without a gradient, bit for bit against
`sgd_bf16_plain` and across two runs; the wrapper's refusals; `PolySGD`
with a bf16 state on the card against the same optimizer on the CPU, bit
for bit; and `Trainer.graph_step` against the eager step for a small
Swin-UNet (both window-attention kernels and the SR kernel in the graph),
f32 and bf16 states, bit for bit under cuDNN's deterministic algorithms.
"""
import pytest
import torch

from icl_tpu_torch.ops import sgd_bf16 as sg

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _leaf(n, offset, seed, scale, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(n + offset, generator=g, device=device) * scale).to(torch.bfloat16)[offset:]


@pytest.mark.parametrize("n", [1, 7, 8, 9, 4093, 65_536, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("with_grad", [True, False])
def test_kernel_is_its_plain_version_bit_for_bit(card, n, offset, with_grad):
    p, g, buf = (_leaf(n, offset, s, sc, card) for s, sc in ((1, 0.05), (2, 0.01), (3, 0.01)))
    lr = torch.tensor(0.013, device=card)
    count = torch.tensor(2 ** 33 + 5, dtype=torch.int64, device=card)  # only the low 32 bits count
    outs = []
    for update in (sg.sgd_bf16_update, sg.sgd_bf16_update, sg.sgd_bf16_plain):
        pc, bc = p.clone(), buf.clone()
        update(pc, g if with_grad else None, bc, lr, count, 0.9, 1e-4, 2 ** 40 + 11, 17)
        outs.append((pc, bc))
    torch.cuda.synchronize()
    for got in outs[:2]:
        assert torch.equal(got[0], outs[2][0]) and torch.equal(got[1], outs[2][1])
    assert int((outs[0][0] != p).sum()) > 0 or n < 8


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    p = torch.zeros(16, dtype=torch.bfloat16, device=card)
    lr = torch.tensor(0.01, device=card)
    count = torch.zeros((), dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="bf16"):
        sg.sgd_bf16_update(p.float(), None, p.float(), lr, count, 0.9, 1e-4, 0, 0)
    with pytest.raises(ValueError, match="lr"):
        sg.sgd_bf16_update(p, None, p.clone(), lr.double(), count, 0.9, 1e-4, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        sg.sgd_bf16_update(p.view(4, 4).t(), None, p.clone().view(4, 4), lr, count, 0.9, 1e-4, 0, 0)
    sg.reset_launch_counts()
    sg.sgd_bf16_update(p, None, p.clone(), lr, count, 0.9, 1e-4, 0, 0)
    assert sg.sgd_bf16_update.launches == 1


def test_polysgd_bf16_on_the_card_is_the_cpu_one(card):
    from icl_tpu_torch.train.optim import PolySGD

    shapes = [(33, 7), (5,), (1024, 3, 3)]
    runs = []
    for device in ("cpu", card):
        params = [torch.nn.Parameter(_leaf(int(torch.tensor(s).prod()), 0, i, 0.05, "cpu").view(s)
                                     .to(device)) for i, s in enumerate(shapes)]
        opt = PolySGD(params, 0.01, 100, state_dtype="bfloat16")
        for step in range(3):
            for i, p in enumerate(params[:2]):  # the last leaf gets no gradient
                p.grad = _leaf(p.numel(), 0, 10 * step + i, 0.01, "cpu").view(p.shape).to(device)
            opt.step()
        runs.append([p.detach().cpu() for p in params] + [b.cpu() for b in opt.momentum_buffers])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_graph_replay_is_the_eager_step(card, state_dtype, tmp_path):
    """A small Swin-UNet (embed 48, head dim 16, window 4, 64^2, batch 4): 3 replays of
    the captured step against 3 eager steps from the same state, the
    parameters, buffers and momentum bit for bit, and the launches the
    graph holds (the two window-attention kernels; the SR kernel per leaf
    with a bf16 state)."""
    import numpy as np

    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.models.swin2d import SwinConfig
    from icl_tpu_torch.train.trainer import Trainer
    from icl_tpu_torch.utils.checkpoint import host_copy

    cfg = ExperimentConfig(root_path="in-memory", exp="card", model="swinunet", num_classes=4,
                           max_iterations=10, batch_size=4, patch_size=(64, 64), labeled_num=7,
                           state_dtype=state_dtype, scan_steps=3, experiments_dir=str(tmp_path),
                           model_kwargs={"swin_cfg": SwinConfig(img_size=64, embed_dim=48,
                                                                window_size=4)})
    torch.manual_seed(0)
    trainer = Trainer(cfg, device=card)
    rng = np.random.default_rng(0)
    batches = [trainer.to_device({"image": rng.standard_normal((4, 1, 64, 64)).astype(np.float32),
                                  "label": rng.integers(0, 4, (4, 64, 64))}) for _ in range(3)]
    s0 = host_copy(trainer.train_state())

    def state():
        st = host_copy(trainer.train_state())
        return list(st["model"].values()) + [s["momentum_buffer"] for s in st["optimizer"]["state"].values()]

    torch.backends.cudnn.deterministic = True
    try:
        for b in batches:
            trainer._stacked_step(b)
        eager = state()
        trainer.load_train_state(s0)
        trainer.graph_step(batches[0])
        trainer.load_train_state(s0)
        for b in batches:
            trainer.graph_step(b)
        replayed = state()
    finally:
        torch.backends.cudnn.deterministic = False
    assert all(torch.equal(a, b) for a, b in zip(eager, replayed))
    launches = trainer.graph_launches
    assert launches["window_attention"] > 0 and launches["window_attention_bwd"] > 0
    want_sr = len(trainer.optimizer.params) if state_dtype == "bfloat16" else 0
    assert launches["sgd_bf16"] == want_sr and trainer.replays == 3
