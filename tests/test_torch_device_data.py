"""icl_tpu_torch's device-side data against the JAX package's
(`icl_tpu/data/device_augment.py`, `device_bank.py`, `pipeline.py:56-88`):
the order-0 zoom (and scipy's), the rotate at every angle the augmentation
draws, each rot90/flip branch, `augment_batch` sample by sample for given
draws, the draws' distribution, and the bank, the index batches and the
raw batches on the synthetic ACDC fixture.

The JAX package draws its augment parameters with threefry inside the
step; the port draws them on the host (`draw_augment_params`), so the
tests hand both the same draws and compare pixels: 0 differing pixels
everywhere. The rotation takes the JAX package's f32 cos and sin of each
angle from a table: XLA's f32 sin is one ulp from the correctly rounded
value at +-7, +-13 and +-19 degrees, and at +-13 degrees on a 255^2 slice
torch's sin would move 2 sources (the odd size here). The bank and the
raw batches are compared twice: both packages resizing through scipy,
and each through its own C++ helper.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage, stats

from icl_tpu.data import device_augment as jda
from icl_tpu.data import device_bank as jdb
from icl_tpu.data import pipeline as jpipe
from icl_tpu.data.acdc import ACDCDataset as JaxACDCDataset
from icl_tpu.data.synth import make_synthetic_acdc

from icl_tpu_torch.data import device_augment as da
from icl_tpu_torch.data import device_bank as db
from icl_tpu_torch.data import pipeline as pp
from icl_tpu_torch.data.acdc import ACDCDataset
from _torch_native import native_on_both, scipy_on_both  # noqa: F401  (fixtures)
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)


def _slices(n, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, s, s)).astype(np.float32),
            rng.integers(0, 4, (n, s, s)).astype(np.uint8))


def _params(branch, k=0, axis=0, angle=0, n=None):
    n = n or len(np.atleast_1d(branch))
    return {key: torch.as_tensor(np.broadcast_to(np.asarray(v, np.int64), (n,)).copy())
            for key, v in (("branch", branch), ("k", k), ("axis", axis), ("angle", angle))}


@pytest.mark.parametrize("n_in,n_out", [(256, 256), (212, 256), (300, 256), (97, 64)])
def test_zoom_nearest_matches_jax_and_scipy(n_in, n_out):
    img, _ = _slices(2, n_in, 0)
    got = da.zoom_nearest(torch.from_numpy(img), n_out).numpy()
    np.testing.assert_array_equal(got, np.asarray(jda.zoom_nearest(jnp.asarray(img), n_out)))
    for i in range(2):
        np.testing.assert_array_equal(got[i], ndimage.zoom(img[i], n_out / n_in, order=0,
                                                           grid_mode=False))


@pytest.mark.parametrize("size", [256, 255])
def test_rotate_matches_jax_at_every_angle(size):
    angles = np.arange(-20, 20)
    img, lab = _slices(len(angles), size, 1)
    got_img, got_lab = da.augment_batch(torch.from_numpy(img), torch.from_numpy(lab),
                                        _params(da.ROTATE, angle=angles, n=len(angles)), size)
    for i, a in enumerate(angles):
        want_img = np.asarray(jda._rotate_nearest(jnp.asarray(img[i]), jnp.float32(a)))
        want_lab = np.asarray(jda._rotate_nearest(jnp.asarray(lab[i], jnp.float32),
                                                  jnp.float32(a))).astype(np.uint8)
        assert int((got_img[i, 0].numpy() != want_img).sum()) == 0, f"image, angle {a}"
        assert int((got_lab[i].numpy() != want_lab).sum()) == 0, f"label, angle {a}"


@pytest.mark.parametrize("size", [8, 9])
def test_rot90_flip_branches_are_exact(size):
    combos = [(k, axis) for k in range(4) for axis in (0, 1)]
    img, lab = _slices(len(combos), size, 2)
    got_img, got_lab = da.augment_batch(
        torch.from_numpy(img), torch.from_numpy(lab),
        _params(da.ROT_FLIP, k=[k for k, _ in combos], axis=[a for _, a in combos], n=len(combos)),
        size)
    for i, (k, axis) in enumerate(combos):
        np.testing.assert_array_equal(got_img[i, 0].numpy(), np.flip(np.rot90(img[i], k), axis))
        np.testing.assert_array_equal(got_lab[i].numpy(), np.flip(np.rot90(lab[i], k), axis))
    same_img, same_lab = da.augment_batch(torch.from_numpy(img), torch.from_numpy(lab),
                                          _params(da.NONE, n=len(combos)), size)
    assert torch.equal(same_img[:, 0], torch.from_numpy(img))
    assert torch.equal(same_lab, torch.from_numpy(lab))


def test_augment_batch_matches_jax_branches_sample_by_sample():
    """Drawn params over 24 slices of 40^2, zoomed to 32^2: each sample as
    the JAX package's branch functions and zoom give it."""
    img, lab = _slices(24, 40, 3)
    params = da.draw_augment_params(np.random.default_rng(4), 24)
    assert {int(b) for b in params["branch"]} == {da.NONE, da.ROT_FLIP, da.ROTATE}
    got_img, got_lab = da.augment_batch(torch.from_numpy(img), torch.from_numpy(lab),
                                        {k: torch.from_numpy(v) for k, v in params.items()}, 32)
    assert got_img.shape == (24, 1, 32, 32) and got_lab.shape == (24, 32, 32)
    assert got_lab.dtype == torch.uint8
    for i in range(24):
        x, y = jnp.asarray(img[i]), jnp.asarray(lab[i])
        if params["branch"][i] == da.ROT_FLIP:
            k, axis = int(params["k"][i]), int(params["axis"][i])
            x, y = (jnp.flip(jnp.rot90(t, k), axis) for t in (x, y))
        elif params["branch"][i] == da.ROTATE:
            a = jnp.float32(params["angle"][i])
            x = jda._rotate_nearest(x, a)
            y = jda._rotate_nearest(y.astype(jnp.float32), a).astype(y.dtype)
        np.testing.assert_array_equal(got_img[i, 0].numpy(), np.asarray(jda.zoom_nearest(x, 32)))
        np.testing.assert_array_equal(got_lab[i].numpy(), np.asarray(jda.zoom_nearest(y, 32)))


def test_draw_augment_params_follow_the_jax_distribution():
    """A chi-square test over 20 000 draws of each: the branch (1/4 none,
    1/2 rot90 + flip, 1/4 rotate: `u1 > 0.5`, else `u2 > 0.5`), k uniform on
    0..3, the axis on {0, 1}, the angle on the integers of [-20, 20)."""
    p = da.draw_augment_params(np.random.default_rng(5), 20_000)
    for key, support, probs in (("branch", [da.NONE, da.ROT_FLIP, da.ROTATE], [0.25, 0.5, 0.25]),
                                ("k", range(4), [0.25] * 4), ("axis", (0, 1), [0.5, 0.5]),
                                ("angle", range(-20, 20), [1 / 40] * 40)):
        counts = np.array([(p[key] == v).sum() for v in support])
        assert counts.sum() == 20_000, key
        assert stats.chisquare(counts, 20_000 * np.asarray(probs)).pvalue > 1e-3, key


@pytest.fixture
def fixture_root(tmp_path):
    pytest.importorskip("h5py")
    root = str(tmp_path / "ACDC")
    make_synthetic_acdc(root, num_slices=12, num_volumes=1, slice_size=40, vol_depth=2, seed=0)
    return root


def test_bank_and_batches_match_jax(fixture_root, scipy_on_both):
    _assert_bank_and_batches_match(fixture_root)


def test_bank_and_batches_match_jax_on_the_native_path(fixture_root, native_on_both):
    _assert_bank_and_batches_match(fixture_root)


def _assert_bank_and_batches_match(fixture_root):
    jax_ds, ds = JaxACDCDataset(fixture_root, "train"), ACDCDataset(fixture_root, "train")
    for canon in (40, 32):
        want_img, want_lab = jdb.build_acdc_bank(jax_ds, canon)
        got_img, got_lab = db.build_acdc_bank(ds, canon, "cpu")
        assert got_img.dtype == torch.float32 and got_lab.dtype == torch.uint8
        np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
        np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    for got, want in ((db.two_stream_index_batches(5, 12, 4, 2, seed=3),
                       jdb.two_stream_index_batches(5, 12, 4, 2, seed=3)),
                      (db.supervised_index_batches(12, 4, seed=3),
                       jdb.supervised_index_batches(12, 4, seed=3))):
        for _ in range(7):
            g, w = next(got), next(want)
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    got = pp.acdc_raw_batches(ds, 5, 4, 2, 32, seed=3)
    want = jpipe.acdc_raw_batches(jax_ds, 5, 4, 2, 32, seed=3)
    for _ in range(4):
        g, w = next(got), next(want)
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["image"].shape == (4, 32, 32) and set(g["augment"]) == set(da.AUGMENT_KEYS)


def test_bank_batches_and_device_stream_on_the_cpu():
    img, lab = _slices(6, 16, 6)
    bank = (torch.from_numpy(img), torch.from_numpy(lab))
    batches = db.bank_batches(*bank, iter([np.array([0, 3], np.int32), np.array([5, 1], np.int32)]),
                              seed=2)
    first = next(batches)
    assert first["image_bank"] is bank[0] and first["label_bank"] is bank[1]
    for key, value in da.draw_augment_params(np.random.default_rng(3), 2).items():
        np.testing.assert_array_equal(first["augment"][key], value)
    raw = [{"image": img[:2], "label": lab[:2], "augment": da.draw_augment_params(
        np.random.default_rng(i), 2)} for i in range(3)]
    with pp.device_stream(iter(raw), "cpu") as stream:
        got = list(stream)
    assert len(got) == 3
    for g, r in zip(got, raw):
        assert g["image"].dtype == torch.float32 and g["label"].dtype == torch.int64
        np.testing.assert_array_equal(g["image"].numpy(), r["image"])
        np.testing.assert_array_equal(g["augment"]["angle"].numpy(), r["augment"]["angle"])
