"""icl_tpu_torch's CTAugment (no PIL) against the JAX package's (PIL 'L'
images): each of the 19 ops pixel for pixel, with 0 differing pixels, at
the 17 levels i / 16 (which hold 0, 0.5 and 1, where the ops' ranges end
or turn to the identity) and the 17 bin centres (i + 0.5) / 17, on a
seeded 256x256 image and a 37x50 one; `rescale` in each of its 6 filters,
`cutout` with the same seeded generator on both sides. Then `cta_apply` on
float [0, 1] images and on labels scaled by 1/255, the policy streams
(probe or not, weak or strong) with the rate updates, `_rate_to_p` and
`stats()` for one seed, and `cta_state.json` written by each package and
read by the other.
"""
import numpy as np
import pytest
from PIL import Image

from icl_tpu.data import ctaugment as jax_cta

from icl_tpu_torch.data import ctaugment as cta

SHAPES = [(256, 256), (37, 50)]
LEVELS = [i / 16 for i in range(17)] + [(i + 0.5) / 17 for i in range(17)]
FILTERS = ["lanczos", "bicubic", "bilinear", "box", "hamming", "nearest"]


def _image(shape, seed: int = 0) -> np.ndarray:
    """Blocks of 4 x 4 pixels with noise on top, inside [6, 249]: flat
    regions (ties for the filters and the resample) and a histogram that
    leaves autocontrast and equalize work to do."""
    rng = np.random.default_rng(seed + shape[0] * 1000 + shape[1])
    h, w = shape
    blocks = rng.integers(16, 240, (h // 4 + 1, w // 4 + 1))
    img = np.kron(blocks, np.ones((4, 4), np.int64))[:h, :w] + rng.integers(-10, 11, (h, w))
    return img.astype(np.uint8)


def _jax_op(name, img, *args, **kw):
    return np.asarray(jax_cta.OPS[name].f(Image.fromarray(img, mode="L"), *args, **kw))


def _assert_same(got, want, what):
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    differ = int((got != want).sum())
    assert differ == 0, f"{what}: {differ} of {want.size} pixels differ"


OP_CASES = [(name, shape) for name in cta.OPS if name not in ("rescale", "cutout")
            for shape in SHAPES]


def test_ops_registered_as_the_jax_package():
    assert list(cta.OPS) == list(jax_cta.OPS)
    assert len(cta.OPS) == 19
    assert {k: op.bins for k, op in cta.OPS.items()} == {k: op.bins for k, op in jax_cta.OPS.items()}
    assert cta.NUM_STRONG_OPS == jax_cta.NUM_STRONG_OPS == 11


@pytest.mark.parametrize("name,shape", OP_CASES, ids=[f"{n}-{h}x{w}" for n, (h, w) in OP_CASES])
def test_op_matches_pil(name, shape):
    img = _image(shape)
    for level in LEVELS:
        args = () if name == "identity" else (level,)
        _assert_same(cta.OPS[name].f(img, *args), _jax_op(name, img, *args), f"{name} {args}")


@pytest.mark.parametrize("method", FILTERS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rescale_matches_pil(shape, method):
    img = _image(shape, seed=1)
    m = (FILTERS.index(method) + 0.5) / 6  # int(m * 5.99) picks the filter
    for level in LEVELS:
        _assert_same(cta.rescale(img, level, m), _jax_op("rescale", img, level, m),
                     f"rescale {level} {method}")


@pytest.mark.parametrize("shape", SHAPES + [(50, 37)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_cutout_matches_pil_with_one_generator(shape):
    img = _image(shape, seed=2)  # no pixel 0 but where a square is cut out
    cut = 0
    for i, level in enumerate(LEVELS):
        got = cta.cutout(img, level, rng=np.random.default_rng(i))
        want = _jax_op("cutout", img, level, rng=np.random.default_rng(i))
        _assert_same(got, want, f"cutout {level}")
        cut += int((got == 0).any())
    assert cut >= len(LEVELS) - 4  # a square of side 1 is empty (size // 2 = 0)


def test_cta_apply_matches_the_jax_package(monkeypatch):
    """Policies drawn by the learner (weak, strong, probe) and two with
    cutout, on a float image and then on a label map scaled by 1/255; the
    JAX cutout's unseeded generator replaced by one seeded as the port's,
    so that both draw the image's square and then the label's from one
    stream."""
    make_rng = np.random.default_rng
    rng = make_rng(3)
    image = np.clip(rng.normal(0.5, 0.25, (48, 40)), 0, 1).astype(np.float32)
    label = (rng.integers(0, 4, (12, 10)).repeat(4, 0).repeat(4, 1)).astype(np.float32) / 255.0
    learner = cta.CTAugment(seed=4)
    policies = [[("cutout", [0.6]), ("rescale", [0.7, 0.2])], [("rotate", [0.9]), ("cutout", [0.3])]]
    policies += [learner.policy(probe=p, weak=w) for p in (False, True) for w in (False, True)
                 for _ in range(6)]
    assert sum(name == "cutout" for ops in policies for name, _ in ops) >= 3
    jax_rng = {}
    monkeypatch.setattr(jax_cta.np.random, "default_rng", lambda *a: jax_rng["now"])
    for seed, ops in enumerate(policies):
        port_rng, jax_rng["now"] = make_rng(seed), make_rng(seed)
        for x in (image, label):
            got, want = cta.cta_apply(x, ops, port_rng), jax_cta.cta_apply(x, ops)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=str(ops))
    assert cta.cta_apply(image, None) is image
    with pytest.raises(ValueError, match="generator"):
        cta.cta_apply(image, [("cutout", [0.5])])


def _flat(rates) -> np.ndarray:
    return np.concatenate([np.concatenate([np.asarray(r) for r in rates[k]])
                           for k in sorted(rates) if len(rates[k])])


def test_policy_stream_rates_and_stats_match():
    """One seed, the same draws: 40 policies of every kind, each probe's
    update applied to both learners with the same proximity."""
    port, ref = cta.CTAugment(seed=5), jax_cta.CTAugment(seed=5)
    prox = np.random.default_rng(6).uniform(0, 1, 40)
    for i in range(40):
        probe, weak = bool(i % 3 == 0), bool(i % 2)
        got, want = port.policy(probe, weak), ref.policy(probe, weak)
        assert got == want, i
        port.update_rates(got, float(prox[i]))
        ref.update_rates(want, float(prox[i]))
    moved = _flat(port.rates) != 1.0
    assert moved.sum() >= 10
    for k in cta.OPS:
        for a, b in zip(port.rates[k], ref.rates[k]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(port._rate_to_p(a), ref._rate_to_p(b))
    assert port.stats() == ref.stats()
    assert list(port.state_dict()) == list(ref.state_dict()) == ["decay", "depth", "th", "rates"]


def test_cta_state_json_carries_across_both_ways(tmp_path):
    port, ref = cta.CTAugment(seed=7), jax_cta.CTAugment(seed=7)
    for i in range(12):
        policy = port.policy(probe=True, weak=bool(i % 2))
        port.update_rates(policy, 0.25 + 0.05 * i)
        ref.update_rates(ref.policy(probe=True, weak=bool(i % 2)), 0.25 + 0.05 * i)
    port.save(str(tmp_path / "port" / "cta_state.json"))
    ref.save(str(tmp_path / "jax" / "cta_state.json"))
    assert (tmp_path / "port" / "cta_state.json").read_text() == \
        (tmp_path / "jax" / "cta_state.json").read_text()
    into_jax, into_port = jax_cta.CTAugment(seed=8), cta.CTAugment(seed=8)
    into_jax.restore(str(tmp_path / "port" / "cta_state.json"))
    into_port.restore(str(tmp_path / "jax" / "cta_state.json"))
    for k in cta.OPS:
        for a, b, c in zip(into_jax.rates[k], into_port.rates[k], port.rates[k]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
    # both go on learning alike from the restored rates
    for i in range(6):
        got, want = into_port.policy(False, bool(i % 2)), into_jax.policy(False, bool(i % 2))
        assert got == want
        into_port.update_rates(got, 0.5)
        into_jax.update_rates(want, 0.5)
    np.testing.assert_array_equal(_flat(into_port.rates), _flat(into_jax.rates))
    with pytest.raises(KeyError, match="rates"):
        into_port.load_state_dict({"decay": 0.99, "depth": 2, "th": 0.85})
