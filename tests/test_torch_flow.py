"""The port's ``methods/flow.py`` against the JAX package's on the CPU, fp32:
the warp, the occlusion mask, ``get_warp``, the pyramidal Lucas-Kanade flow
(at an odd size, where the pyramid drops a row or column, and at 64x64) and
``sliding_window_smooth`` with and without a mask. Inputs are made from a
seed with numpy; each JAX reference is computed once per module.

Tolerances: 1e-5 absolute for the warps, the smoothing average and
``get_warp`` (a flow function that both frameworks compute alike feeds
them); 1e-4 for LK flow and for smoothing driven by it (three refinements
a level of divisions by a 2x2 determinant; the box sums round in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univst_tpu.methods import flow as jf
from univst_torch.methods import flow as tf


def _smooth_image(h, w, seed):
    """A band-limited image in [0, 1], so LK gradients are informative."""
    rng = np.random.default_rng(seed)
    small = torch.tensor(rng.standard_normal((1, 3, -(-h // 8), -(-w // 8))), dtype=torch.float32)
    img = torch.nn.functional.interpolate(small, size=(h, w), mode="bicubic",
                                          align_corners=False)[0].permute(1, 2, 0).numpy()
    return (img - img.min()) / (img.max() - img.min())


def _video(f, h, w, seed=0):
    """f frames of one smooth image moving 2 px a frame, with noise."""
    img = _smooth_image(h, w, seed)
    noise = np.random.default_rng(seed + 1).uniform(0, 0.02, (f, h, w, 3)).astype(np.float32)
    return np.clip(np.stack([np.roll(img, -2 * i, axis=1) for i in range(f)]) + noise, 0, 1)


def _pair_flow(xp):
    """A flow function both frameworks compute alike (elementwise in the
    images), for testing what surrounds the estimator."""
    def flow_fn(a, b):
        return xp.stack([4.0 * (a[..., 0] - b[..., 1]), 3.0 * (a[..., 2] - b[..., 0])], -1)
    return flow_fn


def _mask(f, h, w):
    m = np.zeros((f, h, w), np.float32)
    m[:, h // 4:3 * h // 4, : w // 2] = 1.0
    return m


@pytest.fixture(scope="module")
def lk_refs():
    """JAX's LK flow on two frame pairs (45x37: the pyramid truncates; 64x64)
    and its LK-driven smoothing of a 3-frame video with a mask."""
    refs = {}
    for h, w in ((45, 37), (64, 64)):
        v = _video(2, h, w, seed=h)
        refs[(h, w)] = v, np.asarray(jf.lucas_kanade_flow(jnp.asarray(v[0]), jnp.asarray(v[1])))
    frames, mask = _video(3, 40, 36, seed=5), _mask(3, 40, 36)
    refs["smooth"] = frames, mask, np.asarray(jf.sliding_window_smooth(
        jnp.asarray(frames), radius=1, mask=jnp.asarray(mask)))
    return refs


@pytest.mark.parametrize("gray", [False, True])
def test_warp_matches_jax(gray):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (20, 24) if gray else (20, 24, 3)).astype(np.float32)
    # offsets up to 6 px, some pointing outside the image
    flow = rng.uniform(-6, 6, (20, 24, 2)).astype(np.float32)
    want = np.asarray(jf.warp_image_with_flow(jnp.asarray(img), jnp.asarray(flow)))
    got = tf.warp_image_with_flow(torch.tensor(img), torch.tensor(flow)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_warp_takes_a_batch():
    rng = np.random.default_rng(1)
    img = torch.tensor(rng.uniform(0, 1, (3, 16, 12, 3)), dtype=torch.float32)
    flow = torch.tensor(rng.uniform(-3, 3, (3, 16, 12, 2)), dtype=torch.float32)
    got = tf.warp_image_with_flow(img, flow)
    for i in range(3):
        torch.testing.assert_close(got[i], tf.warp_image_with_flow(img[i], flow[i]),
                                   atol=0, rtol=0)


def test_occlusion_mask_and_apply_match_jax():
    rng = np.random.default_rng(2)
    fwd, bwd = (rng.uniform(-2, 2, (16, 16, 2)).astype(np.float32) for _ in range(2))
    occ = np.asarray(jf.compute_occlusion_mask(jnp.asarray(fwd), jnp.asarray(bwd), 1.5))
    got = tf.compute_occlusion_mask(torch.tensor(fwd), torch.tensor(bwd), 1.5).numpy()
    assert 0 < occ.mean() < 1
    np.testing.assert_array_equal(got, occ)
    a, b = (rng.uniform(0, 1, (16, 16, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jf.apply_occlusion(jnp.asarray(a), jnp.asarray(occ), jnp.asarray(b)))
    got = tf.apply_occlusion(torch.tensor(a), torch.tensor(occ), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_get_warp_matches_jax():
    rng = np.random.default_rng(3)
    i1, i2, r1, r2 = (rng.uniform(0, 1, (18, 22, 3)).astype(np.float32) for _ in range(4))
    want = np.asarray(jf.get_warp(_pair_flow(jnp), *map(jnp.asarray, (i1, i2, r1, r2))))
    got = tf.get_warp(_pair_flow(torch), *map(torch.tensor, (i1, i2, r1, r2))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [(45, 37), (64, 64)])
def test_lucas_kanade_matches_jax(lk_refs, size):
    video, want = lk_refs[size]
    got = tf.lucas_kanade_flow(torch.tensor(video[0]), torch.tensor(video[1])).numpy()
    assert got.shape == want.shape == size + (2,)
    assert np.abs(want).max() > 0.5  # the frames moved: the flow is not trivial
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_lucas_kanade_batch_equals_single_pairs():
    v = torch.tensor(_video(3, 45, 37))
    batched = tf.lucas_kanade_flow(v[:2], v[1:])
    for i in range(2):
        torch.testing.assert_close(batched[i], tf.lucas_kanade_flow(v[i], v[i + 1]),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("with_mask", [False, True])
def test_sliding_window_smooth_matches_jax(with_mask):
    f, h, w = 5, 12, 10
    frames = np.random.default_rng(4).uniform(0, 1, (f, h, w, 3)).astype(np.float32)
    mask = _mask(f, h, w) if with_mask else None
    want = np.asarray(jf.sliding_window_smooth(
        jnp.asarray(frames), flow_fn=_pair_flow(jnp), radius=2,
        mask=None if mask is None else jnp.asarray(mask)))
    got = tf.sliding_window_smooth(torch.tensor(frames), flow_fn=_pair_flow(torch), radius=2,
                                   mask=None if mask is None else torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if with_mask:
        np.testing.assert_array_equal(got[mask > 0], frames[mask > 0])


def test_sliding_window_smooth_with_lk_matches_jax(lk_refs):
    frames, mask, want = lk_refs["smooth"]
    got = tf.sliding_window_smooth(torch.tensor(frames), radius=1, mask=torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_lucas_kanade_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    v = torch.tensor(_video(2, 64, 64))
    want = tf.lucas_kanade_flow(v[0], v[1])
    got = tf.lucas_kanade_flow(v[0].cuda(), v[1].cuda()).cpu()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_cal_optical_flow_cli_writes_the_jax_clis_pngs(tmp_path):
    """The two CLIs on the same pair of images: the occlusion mask and the
    warped image agree to 1 level of 255 (LK flow differs by ~1e-5 px
    between the frameworks, which can flip a rounding)."""
    from PIL import Image

    from univst_torch.cli import cal_optical_flow as tcli
    from univst_tpu.cli import cal_optical_flow as jcli

    video = (_video(2, 48, 40, seed=7) * 255).astype(np.uint8)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(video[i]).save(paths[-1])
    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        occ, warp = str(tmp_path / f"{name}_occ.png"), str(tmp_path / f"{name}_warp.png")
        cli.main(cli.build_parser().parse_args(
            ["--image1", paths[0], "--image2", paths[1], "--occlusion_mask_save_path", occ,
             "--warped_image_save_path", warp, "--threshold", "0.5", "--platform", "cpu"]))
        out[name] = [np.asarray(Image.open(p)).astype(int) for p in (occ, warp)]
    assert out["torch"][0].shape == (48, 40) and out["torch"][1].shape == (48, 40, 3)
    assert 0 < (out["jax"][0] > 0).mean() < 1  # the threshold splits the pixels
    for got, want in zip(out["torch"], out["jax"]):
        assert np.abs(got - want).max() <= 1
